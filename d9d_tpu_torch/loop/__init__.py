from d9d_tpu_torch.loop.generate import generate
from d9d_tpu_torch.loop.serve import ContinuousBatcher, ServeStats

__all__ = ["generate", "ContinuousBatcher", "ServeStats"]
