"""Bias-free projection shared by the attention and MLP blocks.

Stands where the JAX package uses ``flax.linen.Dense(use_bias=False)``:
PyTorch's ``[out, in]`` weight layout (``model_state/from_jax.py``
transposes the flax ``[in, out]`` kernels), lecun-normal init drawn on the
device from an explicit generator, the parameter cast to the compute dtype
at use when the two differ.
"""

import torch
import torch.nn.functional as F
from torch import nn

from d9d_tpu_torch.core.device import resolve_device


class Projection(nn.Module):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        weight = torch.empty(
            (out_features, in_features), dtype=param_dtype or dtype,
            device=resolve_device(device),
        )
        # lecun normal: variance 1 / fan_in
        weight.normal_(0.0, in_features**-0.5, generator=generator)
        self.weight = nn.Parameter(weight, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # casts only where the dtypes differ: a no-op `.to` still costs a
        # dispatch, and a decode step makes hundreds of these calls
        w = self.weight
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        if w.dtype != self.dtype:
            w = w.to(self.dtype)
        return F.linear(x, w)
