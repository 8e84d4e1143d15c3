"""SDPA backend protocol (counterpart of ``d9d_tpu/nn/sdpa/protocol.py``)."""

from typing import Protocol

import torch


class SdpaBackend(Protocol):
    """A scaled-dot-product-attention implementation.

    All backends accept the full feature surface; ones that cannot honor an
    argument must raise, never silently ignore.
    """

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        *,
        causal: bool = True,
        softmax_scale: float | None = None,
        window_size: int | None = None,
        sinks: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        q_segments: torch.Tensor | None = None,
        kv_segments: torch.Tensor | None = None,
    ) -> torch.Tensor: ...
