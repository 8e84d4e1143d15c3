from d9d_tpu_torch.optim.adamw import AdamW
from d9d_tpu_torch.optim.stochastic_adamw import StochasticAdamW

__all__ = ["AdamW", "StochasticAdamW"]
