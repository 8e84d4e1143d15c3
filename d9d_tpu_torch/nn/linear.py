"""Bias-free projection shared by the attention and MLP blocks.

Stands where the JAX package uses ``flax.linen.Dense(use_bias=False)``:
PyTorch's ``[out, in]`` weight layout (``model_state/from_jax.py``
transposes the flax ``[in, out]`` kernels), flax's truncated lecun-normal
init (fan_in = ``in_features``, the first axis of the flax kernel) drawn on
the device from an explicit generator, the parameter held in
``param_dtype`` and cast to the compute dtype at use when the two differ.
``axes`` are the flax kernel's logical axes ``(in, out)``
(``nn/logical_axes.py``); the weight's are those reversed.

It is an ``nn.Linear`` without a bias (``nn.Linear``'s own init, which
would draw the weight once more, is not run), so that tensor
parallelism's DTensor styles take it (``parallel/plan.py``): under them
``weight`` is a ``DTensor`` and the hooks of the style turn the input
and output into and out of ``DTensor``s around this ``forward``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.init import lecun_normal_
from d9d_tpu_torch.nn.logical_axes import Axes


class Projection(nn.Linear):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        axes: Axes = (None, None),
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        nn.Module.__init__(self)
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.flax_axes = tuple(axes)
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), dtype=param_dtype or dtype,
            device=resolve_device(device),
        ))
        self.register_parameter("bias", None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        lecun_normal_(self.weight, self.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # casts only where the dtypes differ: a no-op `.to` still costs a
        # dispatch, and a decode step makes hundreds of these calls
        w = self.weight
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        if w.dtype != self.dtype:
            w = w.to(self.dtype)
        return F.linear(x, w)
