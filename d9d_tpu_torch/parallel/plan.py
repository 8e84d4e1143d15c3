"""Parallelism plans: logical-axis → mesh-axis rule tables (counterpart of
``d9d_tpu/parallel/plan.py``), and their application to a module through
FSDP2's ``fully_shard``.

The rule tables are the JAX package's: ``replicate_plan`` maps nothing;
``fsdp_plan`` shards every parameter's ``embed`` dim, and the two vocab
tables on their ``vocab`` dim, over the fused ``dp_s x cp_s`` axes;
``hsdp_plan`` is the same table, ``dp_r`` replicating because no rule
names it. Tensor and expert parallelism (``with_tp``, ``tp_plan``,
``fsdp_ep_plan``) raise.

:func:`apply_plan` turns a table into ``fully_shard`` calls: one on each
decoder layer (``layers.<i>``) and one on the root, over the ``fsdp_axes``
sub-mesh, or a 2-D ``(dp_r, dp_s x cp_s)`` mesh when ``dp_r > 1`` (HSDP).
Each parameter is sharded on the dim its rule maps to the fsdp axes
(``shard_placement_fn``); a parameter with no such dim (a norm weight, the
attention sinks) is left out of FSDP (``ignored_params``) and stays whole
on every rank, as the JAX plan replicates it, so the train step sums its
gradient itself. Gradients are SUMMED over the shard and replicate dims
(divide factor 1, sum reductions), not averaged: the train step scales by
the global loss weight (``loop/train_step.py``). They are reduced in fp32
(``reduce_dtype``), so narrower parameters accumulate microbatches in fp32
as the one-process step does; FSDP casts its copy of the reduced gradient
back to the parameter's dtype, and :class:`ReducedGradients` keeps the fp32
one for the optimizer.
"""

import dataclasses
import re

import torch
from torch import nn

from d9d_tpu_torch.core.mesh import AXIS_DP_REPLICATE, AXIS_TP, MeshContext
from d9d_tpu_torch.nn import logical_axes as la

LogicalRules = tuple[tuple[str, "str | tuple[str, ...] | None"], ...]

_LAYER = re.compile(r"(.*\.)?layers\.\d+")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """A named logical→mesh rule table."""

    name: str
    rules: LogicalRules

    def mesh_axes(self, axes: la.Axes) -> tuple:
        """The mesh axes each logical axis maps to (``None``: whole)."""
        table = dict(self.rules)
        return tuple(table.get(a) if a is not None else None for a in axes)


def replicate_plan(ctx: MeshContext) -> ParallelPlan:
    return ParallelPlan(name="replicate", rules=())


def _refuse_tp(with_tp: bool) -> None:
    if with_tp:
        raise NotImplementedError(
            "tensor parallelism is not ported yet (ROADMAP A3.2)")


def fsdp_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    """Shard every parameter's embed dim over the fused dp_s×cp_s axes."""
    _refuse_tp(with_tp)
    rules = [(la.EMBED, ctx.fsdp_axes)] + _vocab_table_rules(ctx)
    return ParallelPlan(name="fsdp", rules=tuple(rules))


def _vocab_table_rules(ctx: MeshContext) -> list:
    """Vocab-range tables (embedding + LM head) shard on their vocab dim;
    their feature dim stays whole."""
    return [(la.VOCAB, ctx.fsdp_axes), (la.VOCAB_FEATURES, None)]


def hsdp_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    # dp_r is simply absent from the table → replicated across it
    return dataclasses.replace(fsdp_plan(ctx, with_tp=with_tp), name="hsdp")


def tp_plan(ctx: MeshContext) -> ParallelPlan:
    raise NotImplementedError(
        f"tp_plan: tensor parallelism over {AXIS_TP!r} is not ported yet "
        f"(ROADMAP A3.2)")


def fsdp_ep_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    raise NotImplementedError(
        "fsdp_ep_plan: expert parallelism is not ported yet (ROADMAP A3.3)")


def shard_dims(module: nn.Module, ctx: MeshContext,
               plan: ParallelPlan) -> dict[str, "int | None"]:
    """Each parameter's dim sharded over ``ctx.fsdp_axes`` under ``plan``
    (``None``: whole on every rank). A rule mapping to other mesh axes,
    or two dims of one parameter sharded, raises."""
    out = {}
    for name, layout in la.param_layouts(module).items():
        mapped = plan.mesh_axes(layout.axes)
        dims = [d for d, m in enumerate(mapped) if m]
        for d in dims:
            if tuple(mapped[d]) != tuple(ctx.fsdp_axes):
                raise NotImplementedError(
                    f"{name}: dim {d} maps to {mapped[d]}; only the fsdp "
                    f"axes {ctx.fsdp_axes} are ported (ROADMAP A3.2)")
        if len(dims) > 1:
            raise NotImplementedError(
                f"{name}: dims {dims} all map to the fsdp axes")
        out[name] = dims[0] if dims else None
    return out


def plan_shards(ctx: MeshContext, plan: ParallelPlan) -> bool:
    """Does ``plan`` shard parameters over more than one rank on ``ctx``
    (a rule table that maps anything, and fsdp axes larger than 1)?"""
    return ctx.axis_size(*ctx.fsdp_axes) > 1 and any(
        m for _, m in plan.rules)


def apply_plan(module: nn.Module, ctx: MeshContext,
               plan: ParallelPlan) -> nn.Module:
    """Shard ``module``'s parameters as ``plan`` says (see the module
    docstring); a plan that shards nothing on ``ctx`` wraps nothing and
    returns the module as it is. Works on a module on the meta device (the
    sharded init) as on one with values."""
    if not plan_shards(ctx, plan):
        return module
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    dims = shard_dims(module, ctx, plan)
    by_param = {p: dims[n] for n, p in module.named_parameters()}
    ignored = {p for p, d in by_param.items() if d is None}
    mesh = ctx.submesh(*ctx.fsdp_axes)
    if ctx.axis_size(AXIS_DP_REPLICATE) > 1:
        mesh = ctx.mesh[(AXIS_DP_REPLICATE, mesh.mesh_dim_names[0])]
    kw = dict(mesh=mesh, ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(by_param[p]),
              mp_policy=MixedPrecisionPolicy(reduce_dtype=torch.float32))
    wrapped = [m for name, m in module.named_modules()
               if _LAYER.fullmatch(name)]
    for m in wrapped:
        fully_shard(m, **kw)
    fully_shard(module, **kw)
    for m in wrapped + [module]:
        m.set_gradient_divide_factor(1.0)
        m.set_force_sum_reduction_for_comms(True)
    return module


def fsdp_modules(module: nn.Module) -> list[nn.Module]:
    """The modules of ``module`` that ``fully_shard`` wrapped (empty for a
    module no plan sharded)."""
    from torch.distributed.fsdp import FSDPModule

    return [m for m in module.modules() if isinstance(m, FSDPModule)]


class ReducedGradients:
    """The fp32 reduced gradients of the sharded parameters of a planned
    module, for those held narrower than fp32.

    FSDP reduces in fp32 and then casts the gradient it hands to each
    parameter to the parameter's dtype; the JAX step gives the optimizer
    fp32 gradients. This keeps each FSDP group's fp32 reduction output (the
    reduce-scatter's, after HSDP's all-reduce) through FSDP's all-reduce
    hook, and views each parameter's piece of it: the group's parameters
    with a gradient, in the group's order, each padded to its shard size
    (FSDP's own layout)."""

    def __init__(self, module: nn.Module):
        self._outputs: dict[nn.Module, torch.Tensor] = {}
        for m in fsdp_modules(module):
            m.set_all_reduce_hook(
                lambda out, m=m: self._outputs.__setitem__(m, out))

    def take(self) -> dict[nn.Parameter, torch.Tensor]:
        """``{sharded parameter: its fp32 gradient piece}`` of the last
        backward that reduced; the outputs are released."""
        from torch.distributed.fsdp import fully_shard

        out = {}
        for m, flat in self._outputs.items():
            group = fully_shard.state(m)._fsdp_param_group
            off = 0
            for fp in group.fsdp_params:
                p = fp.sharded_param
                if p.grad is None:
                    continue
                n = fp.sharded_size.numel()
                out[p] = flat[off:off + n].view(fp.sharded_size)
                off += fp.padded_sharded_param_size.numel()
            if off != flat.numel():
                raise RuntimeError(
                    f"ReducedGradients: {off} elements of shards for a "
                    f"reduction output of {flat.numel()}")
        self._outputs.clear()
        return out


__all__ = ["LogicalRules", "ParallelPlan", "ReducedGradients", "apply_plan",
           "fsdp_ep_plan", "fsdp_modules", "fsdp_plan", "hsdp_plan",
           "plan_shards", "replicate_plan", "shard_dims", "tp_plan"]
