from d9d_tpu_torch.core.device import resolve_device

__all__ = ["resolve_device"]
