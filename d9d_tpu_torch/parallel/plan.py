"""Parallelism plans: logical-axis → mesh-axis rule tables (counterpart of
``d9d_tpu/parallel/plan.py``), and their application to a module through
DTensor's tensor-parallel styles and FSDP2's ``fully_shard``.

The rule tables are the JAX package's: ``replicate_plan`` maps nothing;
``fsdp_plan`` shards every parameter's ``embed`` dim, and the two vocab
tables on their ``vocab`` dim, over the fused ``dp_s x cp_s`` axes;
``hsdp_plan`` is the same table, ``dp_r`` replicating because no rule
names it; ``tp_plan`` maps ``heads``, ``kv_heads``, ``mlp`` and ``vocab``
to ``tp``, and ``with_tp=True`` adds those rules to the fsdp tables, the
vocab tables then cut over ``(tp, dp_s, cp_s)``, tp major;
``fsdp_ep_plan`` is the fsdp table plus ``expert`` mapped to
``ep_shard_axes`` and the expert weights' feature dims whole.

:func:`apply_plan` does explicitly what GSPMD does with the JAX tables:

1. tensor parallelism over the ``tp`` sub-mesh, from each parameter's
   logical axes (``nn/logical_axes.py`` ``param_layouts``): a projection
   whose output dim maps to ``tp`` (q, k, v, gate, up) goes
   ``ColwiseParallel``, one whose input dim does (o, down)
   ``RowwiseParallel`` (``parallelize_module``); any other parameter with
   a dim over ``tp`` (the vocab tables, the attention sinks) becomes a
   ``DTensor`` cut on that dim, and its module computes on its local rows
   (``core/collectives.py``). ``fused_qkv`` attention raises, as in JAX;
2. FSDP2: ``fully_shard`` on each decoder layer (``layers.<i>``), on
   each vocab table's module (the embedding and the LM head, so that one
   table at a time is gathered, never both with the root) and on the
   root, over the ``fsdp_axes`` sub-mesh, or a 2-D ``(dp_r, dp_s x
   cp_s)`` mesh when ``dp_r > 1`` (HSDP). Each parameter is sharded on the
   dim its rule maps to the fsdp axes (``shard_placement_fn``): a
   tp-cut projection on its other dim (a block), a vocab table on the dim
   tp cut (FSDP2's ``_StridedShard``: tp outer, fsdp inner). A parameter
   with no such dim (a norm weight, the sinks) is left out of FSDP
   (``ignored_params``) and the train step sums its gradient itself;
3. expert parallelism: each expert weight whose ``expert`` dim maps to the
   ep axes becomes a ``DTensor`` cut on dim 0 over their sub-mesh — this
   rank's ``E / W`` experts, never gathered — and stays out of FSDP and
   tensor parallelism. The step sums its gradient over the data axes
   outside the ep axes (the ranks holding the same experts and other
   tokens) and its norm over the ep group. The model's MoE layers get
   their groups from the model factory (``nn/moe.py``
   ``bind_expert_parallel``).

Gradients are SUMMED over the shard and replicate dims (divide factor 1,
sum reductions), not averaged: the train step scales by the global loss
weight (``loop/train_step.py``). They are reduced in fp32
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
        """The mesh axes each logical axis maps to, as a tuple (``()``:
        whole)."""
        table = dict(self.rules)
        return tuple(_as_axes(table.get(a) if a is not None else None)
                     for a in axes)


def _as_axes(m) -> tuple[str, ...]:
    return (m,) if isinstance(m, str) else tuple(m or ())


def replicate_plan(ctx: MeshContext) -> ParallelPlan:
    return ParallelPlan(name="replicate", rules=())


def fsdp_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    """Shard every parameter's embed dim over the fused dp_s×cp_s axes
    (and, ``with_tp``, the tp rules besides)."""
    rules = [(la.EMBED, ctx.fsdp_axes)]
    if with_tp:
        rules += _tp_rules()
    rules += _vocab_table_rules(ctx, with_tp=with_tp)
    return ParallelPlan(name="fsdp", rules=tuple(rules))


def _vocab_table_rules(ctx: MeshContext, *, with_tp: bool) -> list:
    """Vocab-range tables (embedding + LM head) shard on their vocab dim
    (fused with tp, tp major, when active); their feature dim stays
    whole."""
    vocab_axes = (AXIS_TP,) + ctx.fsdp_axes if with_tp else ctx.fsdp_axes
    return [(la.VOCAB, vocab_axes), (la.VOCAB_FEATURES, None)]


def hsdp_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    # dp_r is simply absent from the table → replicated across it
    return dataclasses.replace(fsdp_plan(ctx, with_tp=with_tp), name="hsdp")


def _tp_rules() -> list:
    return [(la.HEADS, AXIS_TP), (la.KV_HEADS, AXIS_TP), (la.MLP, AXIS_TP),
            (la.VOCAB, AXIS_TP)]


def tp_plan(ctx: MeshContext) -> ParallelPlan:
    return ParallelPlan(name="tp", rules=tuple(_tp_rules()))


def fsdp_ep_plan(ctx: MeshContext, *, with_tp: bool = False) -> ParallelPlan:
    """FSDP/HSDP for the dense parameters, expert parallelism for the MoE
    weights: ``expert`` over the ep axes, their feature dims whole."""
    rules = [(la.EMBED, ctx.fsdp_axes), (la.EXPERT, ctx.ep_shard_axes),
             (la.EXPERT_EMBED, None), (la.EXPERT_MLP, None)]
    if with_tp:
        rules += _tp_rules()
    rules += _vocab_table_rules(ctx, with_tp=with_tp)
    return ParallelPlan(name="fsdp_ep", rules=tuple(rules))


def _cut_dims(module: nn.Module, ctx: MeshContext, plan: ParallelPlan,
              kind: str) -> dict[str, "int | None"]:
    """Each parameter's dim mapped to ``tp`` (``kind="tp"``), to the fsdp
    axes (``"fsdp"``) or, an ``expert`` dim, to the ep axes (``"ep"``)
    under ``plan``; ``None``: none. A dim mapped to other mesh axes, or to
    tp after the fsdp axes, raises, as do two dims of one parameter mapped
    to the same axes."""
    fsdp = tuple(ctx.fsdp_axes)
    ep = tuple(ctx.ep_shard_axes)
    out = {}
    for name, layout in la.param_layouts(module).items():
        dims = []
        for d, (logical, axes) in enumerate(
                zip(layout.axes, plan.mesh_axes(layout.axes))):
            if logical == la.EXPERT and ep and axes == ep:
                if kind == "ep" and ctx.axis_size(*ep) > 1:
                    dims.append(d)
                continue
            rest = tuple(a for a in axes if a != AXIS_TP)
            if rest not in ((), fsdp) or AXIS_TP in axes[1:]:
                raise NotImplementedError(
                    f"{name}: dim {d} maps to {axes}; only tp, the fsdp "
                    f"axes {fsdp} (tp major) and, on an expert dim, the ep "
                    f"axes {ep} are ported")
            if (AXIS_TP in axes) if kind == "tp" else (
                    kind == "fsdp" and bool(rest)):
                dims.append(d)
        if len(dims) > 1:
            raise NotImplementedError(
                f"{name}: dims {dims} map to the same mesh axes")
        out[name] = dims[0] if dims else None
    return out


def shard_dims(module: nn.Module, ctx: MeshContext,
               plan: ParallelPlan) -> dict[str, "int | None"]:
    """Each parameter's dim sharded over ``ctx.fsdp_axes`` under ``plan``
    (``None``: whole over them)."""
    return _cut_dims(module, ctx, plan, "fsdp")


def ep_dims(module: nn.Module, ctx: MeshContext,
            plan: ParallelPlan) -> dict[str, "int | None"]:
    """Each parameter's dim cut over ``ctx.ep_shard_axes`` under ``plan``
    (its ``expert`` dim; ``None``: whole over them)."""
    return _cut_dims(module, ctx, plan, "ep")


def tp_dims(module: nn.Module, ctx: MeshContext,
            plan: ParallelPlan) -> dict[str, "int | None"]:
    """Each parameter's dim cut over ``tp`` under ``plan`` (``None``:
    whole over it)."""
    return _cut_dims(module, ctx, plan, "tp")


def plan_shards(ctx: MeshContext, plan: ParallelPlan) -> bool:
    """Does ``plan`` cut parameters over more than one rank on ``ctx``
    (a rule mapping to mesh axes larger than 1)?"""
    return any(ctx.axis_size(*_as_axes(m)) > 1 for _, m in plan.rules)


def _apply_tp(module: nn.Module, ctx: MeshContext,
              dims: dict[str, int]) -> None:
    """Step 1 of :func:`apply_plan` for the parameters ``dims`` cuts."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp = ctx.tp_size
    for name, m in module.named_modules():
        if getattr(m, "fused_qkv", False):
            raise ValueError(
                "fused_qkv=True under a tp>1 mesh would reshard the q/k/v "
                "kernels every step; use fused_qkv=False with tensor "
                "parallelism")
        heads = (getattr(m, "num_heads", 0), getattr(m, "num_kv_heads", 0))
        if heads[0] % tp or heads[1] % tp:
            raise ValueError(
                f"{name}: heads (q={heads[0]}, kv={heads[1]}) not divisible "
                f"by the head axes ({AXIS_TP!r},) size {tp}")
    mesh = ctx.tp_mesh
    styles = {}
    for name, dim in dims.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = module.get_submodule(mod_name)
        if isinstance(mod, nn.Linear) and leaf == "weight":
            style = ColwiseParallel() if dim == 0 else RowwiseParallel()
            # every rank holds the same values (or none yet, on the meta
            # device): each keeps its chunk, nothing is scattered
            style.src_data_rank = None
            styles[mod_name] = style
        else:
            _cut_param(mod, leaf, mesh, dim)
    parallelize_module(module, mesh, styles)


def _cut_param(mod: nn.Module, leaf: str, mesh, dim: int) -> None:
    """``mod.<leaf>`` as a ``DTensor`` cut on ``dim`` over the 1-D
    ``mesh``: every rank holds the same values (or none yet, on the meta
    device), and each keeps its chunk; nothing is scattered."""
    from torch.distributed.tensor import Shard, distribute_tensor

    p = getattr(mod, leaf)
    mod.register_parameter(leaf, nn.Parameter(
        distribute_tensor(p.detach(), mesh, [Shard(dim)], src_data_rank=None),
        requires_grad=p.requires_grad))


def _apply_ep(module: nn.Module, ctx: MeshContext,
              dims: dict[str, int]) -> None:
    """Step 3 of :func:`apply_plan`: each expert weight becomes a
    ``DTensor`` cut on its expert dim over the ep sub-mesh."""
    from d9d_tpu_torch.nn.moe import MoELayer

    ep = tuple(ctx.ep_shard_axes)
    for name, m in module.named_modules():
        if isinstance(m, MoELayer) and m.ep_axes != ep:
            raise ValueError(
                f"{name}: built with ep_axes={m.ep_axes}, the plan cuts its "
                f"experts over {ep}: build it with ep_axes=ctx.ep_shard_axes")
    mesh = ctx.submesh(*ep)
    for name, dim in dims.items():
        mod_name, _, leaf = name.rpartition(".")
        _cut_param(module.get_submodule(mod_name), leaf, mesh, dim)


def expert_params(module: nn.Module, ctx: MeshContext,
                  plan: ParallelPlan) -> list[nn.Parameter]:
    """The parameters of ``module`` that :func:`apply_plan` cuts over the
    ep axes under ``plan``."""
    return [module.get_parameter(n)
            for n, d in ep_dims(module, ctx, plan).items() if d is not None]


def apply_plan(module: nn.Module, ctx: MeshContext,
               plan: ParallelPlan) -> nn.Module:
    """Cut ``module``'s parameters as ``plan`` says (see the module
    docstring); a plan that cuts nothing on ``ctx`` wraps nothing and
    returns the module as it is. Works on a module on the meta device (the
    sharded init) as on one with values."""
    tp = {}
    if ctx.tp_size > 1:
        tp = {n: d for n, d in tp_dims(module, ctx, plan).items()
              if d is not None}
    ep = {n: d for n, d in ep_dims(module, ctx, plan).items()
          if d is not None}
    dims = shard_dims(module, ctx, plan)
    fsdp = (ctx.axis_size(*ctx.fsdp_axes) > 1
            and any(d is not None for d in dims.values()))
    if tp:
        _apply_tp(module, ctx, tp)
    if ep:
        _apply_ep(module, ctx, ep)
    if not fsdp:
        return module
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    by_param = {p: dims[n] for n, p in module.named_parameters()}
    ignored = {p for p, d in by_param.items() if d is None}
    mesh = ctx.submesh(*ctx.fsdp_axes)
    if ctx.axis_size(AXIS_DP_REPLICATE) > 1:
        mesh = ctx.mesh[(AXIS_DP_REPLICATE, mesh.mesh_dim_names[0])]
    kw = dict(mesh=mesh, ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(by_param[p]),
              mp_policy=MixedPrecisionPolicy(reduce_dtype=torch.float32))
    from torch.distributed.fsdp import register_fsdp_forward_method

    from d9d_tpu_torch.nn.embedding import TokenEmbedding
    from d9d_tpu_torch.nn.heads import LanguageModellingHead

    tables = (TokenEmbedding, LanguageModellingHead)
    wrapped = [m for name, m in module.named_modules()
               if _LAYER.fullmatch(name) or (
                   name and isinstance(m, tables)
                   and any(p not in ignored for p in m.parameters()))]
    for m in wrapped:
        head = isinstance(m, LanguageModellingHead)
        # the head's backward follows its forward at once: keep its table
        # gathered in between rather than gather it twice
        fully_shard(m, **kw, reshard_after_forward=not head)
        if head:
            register_fsdp_forward_method(m, "logits")
    fully_shard(module, **kw)
    for m in wrapped + [module]:
        m.set_gradient_divide_factor(1.0)
        m.set_force_sum_reduction_for_comms(True)
    return module


def fsdp_modules(module: nn.Module) -> list[nn.Module]:
    """The modules of ``module`` that ``fully_shard`` wrapped and that
    hold sharded parameters of their own (empty for a module no plan
    sharded; the root holds none when every table and layer is a unit of
    its own)."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    return [m for m in module.modules() if isinstance(m, FSDPModule)
            and fully_shard.state(m)._fsdp_param_group is not None]


def fsdp_params(module: nn.Module) -> list[nn.Parameter]:
    """The parameters of ``module`` that ``fully_shard`` manages (FSDP
    reduces their gradients)."""
    from torch.distributed.fsdp import fully_shard

    return [fp.sharded_param for m in fsdp_modules(module)
            for fp in fully_shard.state(m)._fsdp_param_group.fsdp_params]


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
           "ep_dims", "expert_params", "fsdp_ep_plan", "fsdp_modules",
           "fsdp_params", "fsdp_plan", "hsdp_plan", "plan_shards",
           "replicate_plan", "shard_dims", "tp_dims", "tp_plan"]
