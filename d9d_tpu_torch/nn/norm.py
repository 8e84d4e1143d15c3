"""RMSNorm block (counterpart of ``d9d_tpu/nn/norm.py``)."""

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.ops import rms_norm
from d9d_tpu_torch.core.collectives import copy_to_group


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
        self.weight = nn.Parameter(torch.empty(
            hidden_size, dtype=param_dtype, device=resolve_device(device)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_centered else 1.0)

    def logical_axes(self) -> dict:
        return {"weight": (None,)}

    def forward(self, x: torch.Tensor, grad_group=None) -> torch.Tensor:
        """``grad_group``: the group whose ranks each apply the weight to
        their own part of the work (the attention's ``q_norm``/``k_norm``
        under tensor parallelism, on the rank's heads); the weight's
        gradient is summed over it, so every rank holds the whole one."""
        return rms_norm(
            x, copy_to_group(self.weight, grad_group), eps=self.eps,
            zero_centered=self.zero_centered
        )
