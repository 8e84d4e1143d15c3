"""Determinism helpers (counterpart of ``d9d_tpu/core/determinism.py``):
seed Python's and numpy's generators shifted by the pipeline stage, and
hand back the model's generator with the same shift; a stateful wrapper
that only the main process saves and loads."""

import random
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def set_seeds(seed: int, *, pp_rank: int = 0) -> torch.Generator:
    """Seed ``random`` and numpy with ``seed + pp_rank`` and return a
    ``torch.Generator`` seeded the same way (the JAX function returns the
    stage's ``jax.random`` key)."""
    shifted = seed + pp_rank
    random.seed(shifted)
    np.random.seed(shifted % (2**32))
    return torch.Generator().manual_seed(shifted)


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class MainProcessOnlyState:
    """Wraps a stateful object so only process 0 saves and loads its
    state."""

    def __init__(self, inner: Any):
        self.inner = inner

    def state_dict(self) -> dict:
        if _process_index() == 0 and hasattr(self.inner, "state_dict"):
            return {"state": self.inner.state_dict()}
        return {}

    def load_state_dict(self, state: dict) -> None:
        if (_process_index() == 0 and "state" in state
                and hasattr(self.inner, "load_state_dict")):
            self.inner.load_state_dict(state["state"])


__all__ = ["MainProcessOnlyState", "set_seeds"]
