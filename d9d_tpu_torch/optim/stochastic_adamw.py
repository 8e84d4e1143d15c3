"""AdamW that keeps bf16 parameters through stochastic rounding
(counterpart of ``d9d_tpu/optim/stochastic_adamw.py`` ``StochasticAdamW``).

Parameters live in their own dtype (bf16 for the large leaves), the step is
computed in fp32 from fp32 gradients, and the write-back to a bf16
parameter rounds stochastically, so the expected trajectory is the fp32
one without an fp32 master copy. Per update ``k`` (0-based count before it),
in fp32:

    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g^2
    c1 = 1 - b1^(k+1)              c2 = 1 - b2^(k+1)
    p = p - lr(k) * (m / c1 / (sqrt(v / c2) + eps) + weight_decay * p)

A bf16 parameter and bf16 moments (``moment_dtype=torch.bfloat16``) are
written by :func:`d9d_tpu_torch.ops.stochastic.stochastic_round_to_bf16`
(kernel B10 on the card), each with its own seed; fp32 leaves and fp32
moments are written as they are. The seed of each rounding is folded on the
host from (``seed``, update count ``k + 1``, leaf index, role 0/1/2 for
parameter/m/v), as the JAX optimizer folds the count and the leaf index into
its key and splits it three ways; it reaches the kernel by value, so the
step reads nothing back. ``state_dict`` holds ``count``, the moments and
``seed``, so a resumed run repeats the noise stream exactly.

A parameter that a plan sharded (a ``DTensor``) is stepped on this rank's
piece, its moments are pieces of the same shape, and every rounding of the
piece passes where it lies in the whole tensor (``ops/stochastic.py``
``shard_index``): each element draws the bits it draws in the unsharded
step, so sharding changes no rounding.

The optimizer owns the parameter write and takes its gradients explicitly:
``step(grads)`` with fp32 gradients in the order of ``params``
(``accepts_fp32_grads``); the train step hands them over without casting
them to the parameters' dtype. Parameters are updated in place.
"""

from collections.abc import Callable, Iterable

import numpy as np
import torch

from d9d_tpu_torch.ops.stochastic import (
    fold_seed,
    shard_index,
    stochastic_round_to_bf16,
)
from d9d_tpu_torch.parallel.shards import local_tensor, shard_bounds

_ROLE_PARAM, _ROLE_MU, _ROLE_NU = 0, 1, 2


class StochasticAdamW:
    # the train step hands over fp32 gradients; it must not cast them
    accepts_fp32_grads = True

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: "float | Callable[[int], float]",
        *,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        moment_dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        if moment_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"moment_dtype must be float32 or bfloat16, got {moment_dtype}")
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.moment_dtype = moment_dtype
        self.seed = seed
        self.count = 0  # updates applied so far
        with torch.no_grad():
            local = [local_tensor(p) for p in self.params]
        self.mu = [torch.zeros_like(p, dtype=moment_dtype) for p in local]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype) for p in local]
        # where each (piece of a) parameter lies in the whole tensor
        self._index = [shard_index(tuple(p.shape), shard_bounds(p))
                       for p in self.params]

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def _write(self, dst: torch.Tensor, x32: torch.Tensor, seed: int,
               index: tuple[int, int, int]) -> None:
        """``dst <- x32``: stochastically rounded into bf16, else a cast."""
        if dst.dtype == torch.bfloat16:
            offset, cols, row_stride = index
            stochastic_round_to_bf16(x32, seed, out=dst, index_offset=offset,
                                     cols=cols, row_stride=row_stride)
        elif x32 is not dst:
            dst.copy_(x32)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (one per parameter, in the order
        of ``params``, any float dtype; computed in fp32)."""
        if len(grads) != len(self.params):
            raise ValueError(
                f"StochasticAdamW.step: {len(grads)} gradients for "
                f"{len(self.params)} parameters")
        k = self.count
        count = k + 1
        lr = self.lr_at(k)
        # 1 - decay**count in fp32, as the JAX optimizer computes it
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        for i, (p, g, m, v) in enumerate(zip(self.params, grads, self.mu,
                                             self.nu)):
            p, index = local_tensor(p), self._index[i]
            g32 = g.float()
            # fp32 moments are updated in place; bf16 ones through a copy
            m32 = m.float().mul_(self.b1).add_(g32, alpha=1.0 - self.b1)
            v32 = v.float().mul_(self.b2).addcmul_(g32, g32,
                                                   value=1.0 - self.b2)
            del g32
            upd = (v32 / c2).sqrt_().add_(self.eps)
            upd = torch.div(m32, c1).div_(upd)
            # fp32 parameters are updated in place; bf16 ones through a copy
            p32 = p.float()
            if self.weight_decay:
                upd.add_(p32, alpha=self.weight_decay)
            p32.sub_(upd, alpha=lr)
            del upd
            self._write(p, p32, fold_seed(self.seed, count, i, _ROLE_PARAM),
                        index)
            self._write(m, m32, fold_seed(self.seed, count, i, _ROLE_MU),
                        index)
            self._write(v, v32, fold_seed(self.seed, count, i, _ROLE_NU),
                        index)
        self.count = count

    def state_dict(self) -> dict:
        return {"count": self.count, "seed": self.seed,
                "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("StochasticAdamW.load_state_dict: the state has "
                             "another number of parameters")
        self.count = int(state["count"])
        self.seed = int(state["seed"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)
