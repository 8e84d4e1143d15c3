from d9d_tpu_torch.model_state.from_jax import load_jax_params

__all__ = ["load_jax_params"]
