from d9d_tpu_torch.optim.adamw import AdamW

__all__ = ["AdamW"]
