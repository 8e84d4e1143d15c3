"""SwiGLU gate op: ``silu(gate) * up`` (counterpart of
``d9d_tpu/ops/swiglu.py``). Plain PyTorch — the JAX op is plain XLA."""

import torch
import torch.nn.functional as F


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def swiglu(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
) -> torch.Tensor:
    """Full SwiGLU FFN: ``down( silu(x @ gate) * (x @ up) )`` with the JAX
    package's ``[in, out]`` weight layout."""
    g = x @ w_gate
    u = x @ w_up
    return silu_mul(g, u) @ w_down
