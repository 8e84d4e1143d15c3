"""AdamW with the semantics of ``optax.adamw``, which the JAX package's
``AdamWProvider`` and ``loop/auto.py`` build.

``optax.adamw(lr, b1, b2, eps, weight_decay)`` is ``scale_by_adam`` →
``add_decayed_weights`` (no mask: EVERY parameter decays, norms and
embeddings included) → ``scale_by_learning_rate``. Per update, in fp32:

    m = (1 - b1) g + b1 m          v = (1 - b2) g^2 + b2 v
    m_hat = m / (1 - b1^(k+1))     v_hat = v / (1 - b2^(k+1))
    p += -lr(k) * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)

where ``k`` is the update count BEFORE this update (optax evaluates the
schedule at the state's count and increments afterwards), so update ``k``
(0-based) uses ``lr(k)``. ``torch.optim.AdamW`` differs: it decays by
``lr * wd`` before the Adam step and a ``LambdaLR`` is stepped after the
optimizer. Parameters are updated in place; moments live beside them in the
parameters' dtype. A parameter that a plan sharded (a ``DTensor``) is
stepped on this rank's piece, and its moments are pieces of the same
shape.

``state_dict`` holds ``count`` (the LR schedule's position) and the
moments as they are on this rank; ``checkpoint_state`` the same with each
moment laid out as its parameter (a ``DTensor`` over the parameter's mesh
and placements, ``parallel/shards.py`` ``like_param``), the form the job
checkpointer saves with DCP and loads in place onto any mesh.
"""

from collections.abc import Callable, Iterable

import numpy as np
import torch

from d9d_tpu_torch.parallel.shards import like_param, local_tensor


class AdamW:
    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: "float | Callable[[int], float]",
        *,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0  # updates applied so far (optax's state.count)
        with torch.no_grad():
            self.mu = [torch.zeros_like(local_tensor(p)) for p in self.params]
            self.nu = [torch.zeros_like(local_tensor(p)) for p in self.params]

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update from the parameters' ``.grad`` (missing grads
        count as zeros, as optax sees a zero cotangent)."""
        k = self.count
        lr = self.lr_at(k)
        # 1 - decay**count in fp32, as optax computes it
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(k + 1))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(k + 1))
        for p, m, v in zip(self.params, self.mu, self.nu):
            g = p.grad
            p = local_tensor(p)
            g = local_tensor(g) if g is not None else torch.zeros_like(p)
            g = g.to(p.dtype)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (m / bc1) / ((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        self.count = k + 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        load_moments_(self, state)

    def checkpoint_state(self) -> dict:
        return checkpoint_state(self)


def checkpoint_state(opt) -> dict:
    """``opt``'s ``count`` as a 0-dim int64 tensor and its moments, each
    laid out as its parameter (sharing the moment's storage: a load into
    it writes the moment)."""
    return {"count": torch.tensor(opt.count, dtype=torch.int64),
            "mu": [like_param(m, p) for m, p in zip(opt.mu, opt.params)],
            "nu": [like_param(v, p) for v, p in zip(opt.nu, opt.params)]}


def load_moments_(opt, state: dict) -> None:
    """Set ``opt``'s ``count`` and copy its moments from ``state`` (a
    :func:`checkpoint_state` or ``state_dict`` form; a moment that already
    is ``state``'s is left as it is)."""
    if len(state["mu"]) != len(opt.mu) or len(state["nu"]) != len(opt.nu):
        raise ValueError(f"{type(opt).__name__}.load_state_dict: the state "
                         f"has another number of parameters")
    opt.count = int(state["count"])
    with torch.no_grad():
        for dst, src in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
            src = local_tensor(src)
            if src.data_ptr() != dst.data_ptr() or src.device != dst.device:
                dst.copy_(src)
