"""The per-stage optimizer aggregate of pipeline-parallel training
(counterpart of ``d9d_tpu/pipelining/training.py``
``PipelinedOptimizer``).

Reference: d9d/pipelining/training/optimizer.py:10 — one logical
optimizer over the disjoint parameter groups of the stages. One optimizer
per stage this rank owns, stepped as a unit, with the JAX step's
arithmetic (``d9d_tpu/pipelining/training.py:57-80``): the gradients are
the stages' unscaled sums; the global norm is ``sqrt(Σ_stages Σ g²) ·
inv_w`` with ``inv_w = 1 / max(Σ weight, 1e-8)`` — each rank sums its
stages' squares and ONE all-reduce over the ``pp`` group sums the ranks'
— and every gradient is multiplied once by ``inv_w · min(1, max_norm /
max(norm, 1e-12))``; the squares of a parameter's pieces (FSDP per
stage) are summed over the groups that cut it first, as in the
one-program step. An optimizer that declares ``accepts_fp32_grads``
takes the gradients through ``step(grads)``; any other reads them from
``.grad``, cast to each parameter's dtype. The anomaly guard and ZeRO
sharding are ROADMAP A9 and raise.
"""

import torch

from d9d_tpu_torch.core.collectives import all_reduce_sum
from d9d_tpu_torch.loop.train_step import _set_grad, cut_groups, global_sq_norm


class PipelinedOptimizer:
    """``optimizers``: stage id → the optimizer of that stage's
    ``params[stage]`` (in the order its gradients come); ``pp_group``:
    the group the squared norms are summed over (``None``: this process
    owns every stage)."""

    def __init__(self, optimizers: dict, params: dict, *,
                 max_grad_norm: "float | None" = 1.0, pp_group=None,
                 anomaly_freeze: bool = False, zero_axis=None):
        if anomaly_freeze or zero_axis is not None:
            raise NotImplementedError(
                "PipelinedOptimizer: the anomaly guard and ZeRO sharding "
                "are not ported yet (ROADMAP A9)")
        if set(optimizers) != set(params):
            raise ValueError("one optimizer per stage")
        self.optimizers = optimizers
        self.params = params
        self.max_grad_norm = max_grad_norm
        self.pp_group = pp_group

    def step(self, grads: dict, weight_sum: torch.Tensor) -> torch.Tensor:
        """Scale, clip and apply ``grads`` (stage id → gradient sums, this
        rank's pieces of cut parameters, in place) → the global norm of
        the scaled gradients."""
        with torch.no_grad():
            stages = sorted(grads)
            flat = [g for s in stages for g in grads[s]]
            groups = [cut_groups(p) for s in stages for p in self.params[s]]
            sq = (global_sq_norm(flat, groups) if flat else
                  torch.zeros((), dtype=torch.float32,
                              device=weight_sum.device))
            if self.pp_group is not None:
                all_reduce_sum([sq], self.pp_group)
            inv_w = 1.0 / torch.clamp(weight_sum, min=1e-8)
            norm = sq.sqrt() * inv_w
            factor = inv_w
            if self.max_grad_norm is not None:
                factor = inv_w * torch.clamp(
                    self.max_grad_norm / torch.clamp(norm, min=1e-12),
                    max=1.0)
            if flat:
                torch._foreach_mul_(flat, factor)
        for s in stages:
            opt = self.optimizers[s]
            if getattr(opt, "accepts_fp32_grads", False):
                opt.step(grads[s])
            else:
                with torch.no_grad():
                    for p, g in zip(self.params[s], grads[s]):
                        _set_grad(p, g)
                opt.step()
                for p in self.params[s]:
                    p.grad = None
        return norm


__all__ = ["PipelinedOptimizer"]
