from d9d_tpu_torch.ops.attention.eager import eager_sdpa

__all__ = ["eager_sdpa"]
