"""The training step: microbatch loop, weighted-loss grad accumulation,
global-norm clipping, optimizer update (counterpart of
``d9d_tpu/loop/train_step.py`` ``build_train_step``).

The contract is the JAX step's:

- gradients of each microbatch's ``loss_sum`` accumulate in ``grad_dtype``
  (fp32): in the parameters' ``.grad`` for parameters held in it, and for
  narrower ones (bf16) in fp32 accumulators the step holds — autograd
  gives such a parameter a gradient of its own dtype per microbatch, as
  JAX's cotangent has the primal's dtype, and each is added into its
  accumulator and freed (parameters held wider than ``grad_dtype`` raise);
- sum-then-scale: the summed gradients are multiplied by
  ``1 / max(Σ weight, 1e-8)`` — not a mean of microbatch means;
- the clip factor is ``min(1, max_norm / max(norm, 1e-12))`` over the
  global L2 norm of all gradients (NOT ``torch.nn.utils.clip_grad_norm_``,
  which divides by ``norm + 1e-6``);
- the update: an optimizer that declares ``accepts_fp32_grads`` gets the
  gradients in ``grad_dtype`` through ``step(grads)`` and owns the
  parameter write; any other gets them cast to each parameter's dtype in
  ``.grad`` and is called as ``step()``;
- the metrics ``loss``, ``grad_norm``, ``loss_weight`` and
  ``task/<k>`` (task statistics summed over microbatches), as device
  scalars — nothing is read back here;
- over a mesh (``reduce_group``, the group of the data axes ``dp_r x
  dp_s x cp_s`` over which the batch's rows and positions are cut) each
  rank runs the microbatch loop on its rows and sequence chunk, and
  everything is summed once a step, after the loop, as the JAX step's
  psum: ONE sum all-reduce over the group covers ``loss_sum``,
  ``weight_sum``, the task statistics and the fp32 gradients of the
  parameters FSDP does not manage; the ones it manages are reduced by
  FSDP at the last microbatch's backward (gradient sync is off for the
  others), summed over the shard and replicate dims into this rank's
  piece. Ranks along ``cp_r`` and ``tp`` hold the same rows and positions
  and are not summed over: ``cp_r`` replicas compute the same sums, and
  tensor parallelism gives every tp rank the whole loss and the whole
  gradient of each parameter it holds whole (``core/collectives.py``; the
  norms, ``q_norm``/``k_norm`` included) and its own piece of each
  parameter it cut. An expert weight cut over the ep axes
  (``fsdp_ep_plan``) already holds the work of every token its experts
  took in across the ep group: its gradient is summed over
  ``sum_groups[p]`` instead, the data axes outside the ep axes. Then
  sum-then-scale, and ONE rule for the global
  norm: each gradient's squares are summed over the mesh dims its
  parameter is cut over (none for a whole one, the fsdp axes and/or tp
  for a ``DTensor`` piece, the ep axes for an expert piece), never over
  those that replicate it. Narrow
  sharded parameters take their fp32 gradients from ``ReducedGradients``.
  The clip and the update follow unchanged, on each rank's pieces.

The anomaly guard, ZeRO sharding, the split update and the numerics plane
are not ported: asking for them raises ``NotImplementedError``.
"""

from collections.abc import Callable

import torch
from torch import nn

from torch.distributed.tensor import DTensor

from d9d_tpu_torch.core.collectives import all_reduce_sum
from d9d_tpu_torch.loop.control.task import TrainTask
from d9d_tpu_torch.parallel.plan import (
    ReducedGradients,
    fsdp_modules,
    fsdp_params,
)
from d9d_tpu_torch.parallel.shards import local_tensor, shard_cuts


def _sum_squares(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([g.float().pow(2).sum() for g in grads]).sum()


def cut_groups(p: torch.Tensor) -> tuple:
    """The process groups of the mesh dims ``p`` is cut over (``()``: a
    whole parameter)."""
    return tuple(p.device_mesh.get_group(mesh_dim)
                 for _, mesh_dim in shard_cuts(p))


def global_sq_norm(grads: list[torch.Tensor],
                   groups: "list[tuple] | None" = None) -> torch.Tensor:
    """``Σ_leaves Σ g²`` in fp32 of the gradients ``grads``, each this
    rank's piece over the process groups ``groups[i]`` (:func:`cut_groups`;
    ``()`` or ``None``: whole on every rank): the squares of the pieces cut
    over the same groups are summed over each of those groups in turn,
    once."""
    by_groups: dict[tuple, list[torch.Tensor]] = {}
    for g, gr in zip(grads, groups or [()] * len(grads)):
        by_groups.setdefault(gr, []).append(g)
    total = None
    for gr, gs in by_groups.items():
        sq = _sum_squares(gs)
        for group in gr:
            all_reduce_sum([sq], group)
        total = sq if total is None else total + sq
    return total


def global_grad_norm(grads: list[torch.Tensor],
                     groups: "list[tuple] | None" = None) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ g²)`` in fp32 (optax ``global_norm``):
    :func:`global_sq_norm`'s square root."""
    return global_sq_norm(grads, groups).sqrt()


def _set_grad(p: torch.Tensor, g: torch.Tensor) -> None:
    """``p.grad`` := ``g`` (this rank's piece for a ``DTensor`` ``p``) in
    ``p``'s dtype."""
    g = g.to(p.dtype)
    if isinstance(p, DTensor):
        g = DTensor.from_local(g, p.device_mesh, p.placements,
                               run_check=False, shape=p.shape,
                               stride=p.stride())
    p.grad = g


def build_train_step(
    *,
    module: nn.Module,
    task: TrainTask,
    optimizer,
    num_microbatches: int,
    max_grad_norm: float | None = 1.0,
    grad_dtype: torch.dtype | None = torch.float32,
    anomaly_policy: str | None = None,
    zero=None,
    split_update: bool = False,
    numerics: bool = False,
    reduce_group=None,
    sum_groups: "dict | None" = None,
) -> Callable[[list[dict]], dict[str, torch.Tensor]]:
    """Build the step over ``module``'s trainable parameters:
    ``step(microbatches) -> metrics``, taking the ``num_microbatches``
    staged microbatches of one optimizer step. ``reduce_group``: the
    process group the step's sums are all-reduced over (``None``: no
    other rank holds other rows or positions); ``sum_groups``: ``{param:
    group}`` for parameters FSDP does not manage whose gradients are
    summed over another group (``None``: over none)."""
    unported = {"anomaly_policy": anomaly_policy is not None,
                "zero": zero is not None, "split_update": split_update,
                "numerics": numerics}
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(
            f"build_train_step: {', '.join(on)} not ported yet")
    params = [p for p in module.parameters() if p.requires_grad]
    # parameters held narrower than grad_dtype accumulate outside .grad
    narrow = [grad_dtype is not None and p.dtype != grad_dtype for p in params]
    wide = {str(p.dtype) for p, n in zip(params, narrow)
            if n and p.dtype.itemsize >= grad_dtype.itemsize}
    if wide:
        raise NotImplementedError(
            f"parameters held in {sorted(wide)} with grad_dtype {grad_dtype}: "
            f"only parameters narrower than grad_dtype are accumulated apart")
    fp32_grads = getattr(optimizer, "accepts_fp32_grads", False)
    managed = set(fsdp_params(module))
    # FSDP reduces these gradients; the step sums the others
    by_fsdp = [p in managed for p in params]
    groups = [cut_groups(p) for p in params]
    sum_groups = sum_groups or {}
    # the group each gradient FSDP does not reduce is summed over
    grad_groups = [sum_groups.get(p, reduce_group) for p in params]
    planned = bool(managed)
    reduced = (ReducedGradients(module)
               if any(f and n for f, n in zip(by_fsdp, narrow)) else None)

    def step(microbatches: list[dict]) -> dict[str, torch.Tensor]:
        if len(microbatches) != num_microbatches:
            raise ValueError(f"expected {num_microbatches} microbatches, got "
                             f"{len(microbatches)}")
        for p in params:
            p.grad = None
        accs: list[torch.Tensor | None] = [None] * len(params)
        loss_sum = weight_sum = None
        metrics_sum: dict[str, torch.Tensor] = {}
        for j, mb in enumerate(microbatches):
            if planned:  # FSDP reduces once, at the last backward
                module.set_requires_gradient_sync(j == len(microbatches) - 1)
            # each backward adds this microbatch's gradients into .grad
            loss, weight, metrics = task.loss_fn(module, mb)
            loss.backward()
            with torch.no_grad():
                for i, p in enumerate(params):
                    if narrow[i] and not by_fsdp[i] and p.grad is not None:
                        g = local_tensor(p.grad)
                        if accs[i] is None:
                            accs[i] = g.to(grad_dtype)
                        else:
                            accs[i].add_(g)
                        p.grad = None
            loss, weight = loss.detach().float(), weight.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            weight_sum = weight if weight_sum is None else weight_sum + weight
            for k, v in metrics.items():
                v = v.detach()
                metrics_sum[k] = v if k not in metrics_sum else metrics_sum[k] + v

        with torch.no_grad():
            fp32 = reduced.take() if reduced is not None else {}
            grads = []
            for i, p in enumerate(params):
                if narrow[i]:
                    g = fp32.get(p) if by_fsdp[i] else accs[i]
                else:
                    g = None if p.grad is None else local_tensor(p.grad)
                if g is None:  # unused by the loss: a zero gradient
                    g = torch.zeros_like(local_tensor(p),
                                         dtype=grad_dtype or p.dtype)
                grads.append(g)
            del accs, fp32
            # this rank's rows' and positions' part, summed here
            whole = [g for g, f, gr in zip(grads, by_fsdp, grad_groups)
                     if not f and gr is reduce_group]
            if reduce_group is not None:
                # copies: a task may hand back one tensor as both its weight
                # and a statistic, and each must be summed once
                keys = sorted(metrics_sum)
                sums = [x.clone() for x in [loss_sum, weight_sum]
                        + [metrics_sum[k] for k in keys]]
                all_reduce_sum(whole + sums, reduce_group)
                loss_sum, weight_sum = sums[:2]
                metrics_sum = dict(zip(keys, sums[2:]))
            others: dict = {}
            for g, f, gr in zip(grads, by_fsdp, grad_groups):
                if not f and gr is not reduce_group and gr is not None:
                    others.setdefault(gr, []).append(g)
            for gr, gs in others.items():
                all_reduce_sum(gs, gr)
            # sum-then-scale by the global weight
            inv_w = 1.0 / torch.clamp(weight_sum, min=1e-8)
            torch._foreach_mul_(grads, inv_w)
            loss = loss_sum * inv_w
            grad_norm = global_grad_norm(grads, groups)
            if max_grad_norm is not None:
                clip = torch.clamp(
                    max_grad_norm / torch.clamp(grad_norm, min=1e-12), max=1.0)
                torch._foreach_mul_(grads, clip)
            if not fp32_grads:
                for p, g in zip(params, grads):
                    _set_grad(p, g)
        if fp32_grads:
            optimizer.step(grads)
        else:
            optimizer.step()
        del grads
        out = {"loss": loss, "grad_norm": grad_norm, "loss_weight": weight_sum}
        out.update({f"task/{k}": v for k, v in metrics_sum.items()})
        return out

    return step


def build_eval_step(*, module: nn.Module, task: TrainTask,
                    reduce_group=None):
    """Forward-only: ``Σ loss_sum / max(Σ weight, 1e-8)`` over the
    microbatches (and over ``reduce_group``'s ranks: the data axes), as a
    device scalar. A planned module's FSDP units are resharded after it:
    with no backward to reshard them, the root would keep its parameters
    gathered (and registered in place of its pieces)."""
    planned = fsdp_modules(module)

    @torch.no_grad()
    def step(microbatches: list[dict]) -> torch.Tensor:
        loss_sum = weight_sum = 0.0
        for mb in microbatches:
            loss, weight, _ = task.loss_fn(module, mb)
            loss_sum = loss_sum + loss.float()
            weight_sum = weight_sum + weight.float()
        for m in planned:
            m.reshard()
        if reduce_group is not None:
            loss_sum, weight_sum = loss_sum.clone(), weight_sum.clone()
            all_reduce_sum([loss_sum, weight_sum], reduce_group)
        return loss_sum / torch.clamp(torch.as_tensor(weight_sum), min=1e-8)

    return step
