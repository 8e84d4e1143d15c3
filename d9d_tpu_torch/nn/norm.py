"""RMSNorm block (counterpart of ``d9d_tpu/nn/norm.py``)."""

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.ops import rms_norm


class RMSNorm(nn.Module):
    """Root-mean-square layer norm with optional zero-centered weight.

    ``zero_centered=True`` stores the scale as an offset from 1, so a fresh
    init (zeros) is an identity scale either way. Parameter: ``weight
    [hidden_size]``.
    """

    def __init__(
        self,
        hidden_size: int,
        eps: float = 1e-6,
        zero_centered: bool = False,
        *,
        param_dtype: torch.dtype = torch.float32,
        device: "torch.device | str | None" = None,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.zero_centered = zero_centered
        init = torch.zeros if zero_centered else torch.ones
        self.weight = nn.Parameter(
            init(hidden_size, dtype=param_dtype, device=resolve_device(device))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(
            x, self.weight, eps=self.eps, zero_centered=self.zero_centered
        )
