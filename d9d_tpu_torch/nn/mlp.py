"""SwiGLU feed-forward block (counterpart of ``d9d_tpu/nn/mlp.py``)."""

import torch
from torch import nn

from d9d_tpu_torch.nn.linear import Projection
from d9d_tpu_torch.nn.logical_axes import EMBED, MLP
from d9d_tpu_torch.ops import silu_mul


class SwiGLU(nn.Module):
    """gate/up/down projections around the silu-mul op. Parameters:
    ``gate_proj``, ``up_proj``, ``down_proj`` (``.weight [out, in]``)."""

    def __init__(
        self,
        hidden_size: int,
        intermediate_size: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.gate_proj = Projection(hidden_size, intermediate_size,
                                    axes=(EMBED, MLP), **kw)
        self.up_proj = Projection(hidden_size, intermediate_size,
                                  axes=(EMBED, MLP), **kw)
        self.down_proj = Projection(intermediate_size, hidden_size,
                                    axes=(MLP, EMBED), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(silu_mul(self.gate_proj(x), self.up_proj(x)))
