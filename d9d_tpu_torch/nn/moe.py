"""Mixture-of-Experts blocks: router, grouped experts, shared expert, layer
(counterpart of ``d9d_tpu/nn/moe.py``).

``ep_axes=None`` is the local path: every expert on this device. With
``ep_axes`` (mesh axis names, ``MeshContext.ep_shard_axes``) the layer runs
the expert-parallel path (``_forward_ep``, ``ops/ep_dispatch.py``): each
rank of the ep group holds ``E / W`` experts — ``fsdp_ep_plan`` cuts the
expert weights on dim 0 over those axes — and pairs travel to their
expert's owner and back through an all-to-all. In the token-layout flow
(``token_axes``) each rank dispatches its own block; in the legacy flow
(``token_axes=None``) the pieces of the JAX package's flattened global
batch, which the layer first gathers (:class:`LegacyPieces`). The layer learns its groups
from the mesh through :func:`bind_expert_parallel` (the model factory
calls it); ``ep_axes=()`` is one rank owning every expert and needs none.
Either way the experts run the layer's fused expert-FFN kernel
(``moe_ffn``): on the EP path over the received rows, at ``e_loc``
experts, one pair a row, probs 1 (the probs weigh the results after they
come home, as in the JAX package).

Where the JAX layer sows its per-expert load into flax's ``moe_stats``
collection, the port's layer hands ``tokens_per_expert`` to a collector
that the caller opens with :func:`collect_tokens_per_expert` around ONE
forward. A layer called outside such a window counts nothing — in
particular the recomputation of a layer's forward under full remat
(``torch.utils.checkpoint``), which runs during the backward, so every
layer call is counted once, as the JAX ``sow`` counts it.
"""

import contextlib
import dataclasses
import itertools
import math
from typing import Literal, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from d9d_tpu_torch.core.collectives import (
    copy_pairs,
    exchange_rows,
    gather_from_group,
    split_to_group,
)
from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.core.mesh import MESH_AXIS_NAMES, MeshContext
from d9d_tpu_torch.nn.init import variance_scaling_uniform_
from d9d_tpu_torch.nn.linear import Projection
from d9d_tpu_torch.nn.logical_axes import (
    EMBED,
    EXPERT,
    EXPERT_EMBED,
    EXPERT_MLP,
)
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.ops.ep_dispatch import ep_dispatch_compute_combine
from d9d_tpu_torch.ops.moe import grouped_swiglu_apply, sort_tokens_by_expert
from d9d_tpu_torch.ops.moe_ffn import MOE_FFN_VARIANTS, fused_moe_ffn_apply

MoeFfn = Literal["aligned", "gather", "gather_combine"]


@dataclasses.dataclass(frozen=True)
class SharedExpertParameters:
    """Config of the optional shared expert."""

    intermediate_size: int
    enable_gate: bool = False


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last dim, largest
    first, ties lower index first — ``lax.top_k``'s order. ``torch.topk``
    gives tied values in another order; a stable descending sort does not."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


class TopKRouter(nn.Module):
    """Softmax gate (fp32) → optional expert bias (selection only) →
    optional group-limited eligibility → top-k → optional renormalization.
    Parameter: ``gate.weight [E, dim]``; buffer ``expert_bias [E]`` fp32
    with ``enable_expert_bias`` (not a parameter: no gradient, no update)."""

    def __init__(
        self,
        dim: int,
        num_experts: int,
        top_k: int,
        *,
        renormalize_probabilities: bool = True,
        enable_expert_bias: bool = False,
        n_group: int = 1,
        topk_group: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if n_group > 1 and num_experts % n_group != 0:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"n_group {n_group}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.renormalize_probabilities = renormalize_probabilities
        self.n_group, self.topk_group = n_group, topk_group
        self.gate = Projection(dim, num_experts, axes=(EMBED, None),
                               dtype=dtype, param_dtype=param_dtype,
                               device=device, generator=generator)
        self.register_buffer("expert_bias", torch.zeros(
            num_experts, dtype=torch.float32, device=resolve_device(device))
            if enable_expert_bias else None)

    def reset_parameters(self, generator: torch.Generator | None = None):
        # the gate draws its own; the bias starts at zero
        if self.expert_bias is not None:
            self.expert_bias.zero_()

    def forward(self, hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``hidden [..., D]`` → ``(indices [..., K] int64, probs [..., K]
        fp32)``."""
        probs = torch.softmax(self.gate(hidden).float(), dim=-1)
        sel = probs
        if self.expert_bias is not None:
            sel = sel + self.expert_bias
        if self.n_group > 1:
            per = self.num_experts // self.n_group
            group_score = sel.reshape(*sel.shape[:-1], self.n_group,
                                      per).amax(dim=-1)
            top_g = top_k_indices(group_score, self.topk_group)
            gmask = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
                -1, top_g, True)
            sel = sel.masked_fill(~gmask.repeat_interleave(per, dim=-1),
                                  float("-inf"))
        idx = top_k_indices(sel, self.top_k)
        selected = torch.gather(probs, -1, idx)
        if self.renormalize_probabilities:
            selected = selected / (selected.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, selected


class GroupedSwiGLU(nn.Module):
    """E SwiGLU experts. Parameters ``gate_proj``, ``up_proj`` ``[E, hidden,
    inter]`` and ``down_proj [E, inter, hidden]`` — the JAX layout, not
    transposed — drawn as flax's ``variance_scaling(1/3, "fan_in",
    "uniform", in_axis=1, out_axis=2)`` draws them (fan-in ``E * in``).
    Under ``fsdp_ep_plan`` each is a ``DTensor`` holding this rank's
    experts; :meth:`reset_parameters` draws the whole ``[E, in, out]``
    value and writes that piece, as the one-process build draws it."""

    def __init__(
        self,
        hidden_dim: int,
        intermediate_dim: int,
        num_experts: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        dev = resolve_device(device)

        def weight(din, dout):
            return nn.Parameter(torch.empty((num_experts, din, dout),
                                            dtype=param_dtype or dtype,
                                            device=dev))

        self.gate_proj = weight(hidden_dim, intermediate_dim)
        self.up_proj = weight(hidden_dim, intermediate_dim)
        self.down_proj = weight(intermediate_dim, hidden_dim)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        for w in (self.gate_proj, self.up_proj, self.down_proj):
            variance_scaling_uniform_(w, 1.0 / 3.0, w.shape[0] * w.shape[1],
                                      generator)

    def logical_axes(self) -> dict:
        return {"gate_proj": (EXPERT, EXPERT_EMBED, EXPERT_MLP),
                "up_proj": (EXPERT, EXPERT_EMBED, EXPERT_MLP),
                "down_proj": (EXPERT, EXPERT_MLP, EXPERT_EMBED)}

    def forward(self, permuted_x, permuted_probs, group_sizes) -> torch.Tensor:
        """Expert-sorted rows ``[M, D]`` + probs ``[M]`` → prob-weighted
        outputs ``[M, D]`` through the unfused chain (``MoELayer`` runs the
        fused kernels on these parameters instead)."""
        return grouped_swiglu_apply(permuted_x, permuted_probs, group_sizes,
                                    self.gate_proj, self.up_proj,
                                    self.down_proj, self.dtype)


class SharedSwiGLU(nn.Module):
    """Always-on expert (``expert``, a SwiGLU) with an optional sigmoid
    gate (``gate``, a width-1 projection)."""

    def __init__(
        self,
        hidden_size: int,
        params_config: SharedExpertParameters,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.expert = SwiGLU(hidden_size, params_config.intermediate_size, **kw)
        self.gate = (Projection(hidden_size, 1, **kw)
                     if params_config.enable_gate else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.expert(x)
        if self.gate is not None:
            out = out * torch.sigmoid(self.gate(x))
        return out


@contextlib.contextmanager
def collect_tokens_per_expert(module: nn.Module):
    """Collect the ``tokens_per_expert`` of every :class:`MoELayer` of
    ``module`` called inside the window → a list of ``[E]`` int64 device
    tensors, one per layer call (empty for a model without MoE layers)."""
    layers = [m for m in module.modules() if isinstance(m, MoELayer)]
    counts: list[torch.Tensor] = []
    for layer in layers:
        layer._stats_sink = counts
    try:
        yield counts
    finally:
        for layer in layers:
            layer._stats_sink = None


@dataclasses.dataclass(frozen=True, eq=False)
class LegacyPieces:
    """Where the legacy flow's rows live on the mesh. The JAX package
    flattens the global ``[B, T]`` batch (row ``b·T + t``) and cuts it over
    the ep axes into ``W`` pieces, every ep group computing all of them.
    Here each rank holds its own ``[b_loc, t_loc]`` block, and of it the
    ``1/dup`` sub-block it dispatches in the token flow; ``group`` is the
    group of the ranks whose sub-blocks together are the global batch
    (the token-carrying axes and the ep axes), ``members[i]`` the
    coordinates of its rank ``i`` on ``axes`` (mesh order), and ``sizes``
    every mesh axis's size."""

    group: object
    rank: int
    axes: tuple[str, ...]
    members: np.ndarray
    sizes: dict
    batch_axes: tuple[str, ...]
    seq_axes: tuple[str, ...]
    ep_axes: tuple[str, ...]
    dup_axes: tuple[str, ...]
    _routes: dict = dataclasses.field(default_factory=dict, repr=False)

    def _index(self, coords, axes) -> np.ndarray:
        """Members' row-major index over ``axes`` (an axis not in
        ``self.axes`` has size 1 here)."""
        idx = np.zeros(len(coords), np.int64)
        for a in axes:
            col = (coords[:, self.axes.index(a)] if a in self.axes
                   else np.zeros(len(coords), np.int64))
            idx = idx * self.sizes[a] + col
        return idx

    def routes(self, b_loc: int, t_loc: int, device) -> "LegacyRoutes | None":
        """The two exchanges of a call on ``[b_loc, t_loc]`` blocks (made
        once a shape and device); ``None`` where every rank's sub-block is
        its piece (no exchange: the token flow)."""
        key = (b_loc, t_loc, str(device))
        if key not in self._routes:
            self._routes[key] = self._make_routes(b_loc, t_loc, device)
        return self._routes[key]

    def _make_routes(self, b_loc, t_loc, device) -> "LegacyRoutes | None":
        m = self.members
        prod = lambda axes: math.prod(self.sizes[a] for a in axes)  # noqa: E731
        seq = t_loc * prod(self.seq_axes)
        world = prod(self.ep_axes)
        n_full = b_loc * t_loc
        n_sub = n_full // prod(self.dup_axes)
        n_global = n_full * prod(self.batch_axes) * prod(self.seq_axes)
        n_piece = n_global // world
        if n_piece * world != n_global:
            raise ValueError(f"legacy EP flow: {n_global} tokens do not cut "
                             f"into {world} pieces")
        bc = self._index(m, self.batch_axes)
        sc = self._index(m, self.seq_axes)
        dc = self._index(m, self.dup_axes)
        piece = self._index(m, self.ep_axes)
        others = [a for a in self.axes if a not in self.ep_axes]
        replica = self._index(m, others)
        j = np.arange(n_sub)[None] + (dc * n_sub)[:, None]
        rows = (((bc * b_loc)[:, None] + j // t_loc) * seq
                + (sc * t_loc)[:, None] + j % t_loc)  # [members, n_sub]
        if np.array_equal(rows, piece[:, None] * n_piece
                          + np.arange(n_piece)[None]):
            return None
        of = rows // n_piece
        me = self.rank
        # out: my sub-block's rows to every member holding their piece
        send = [np.flatnonzero(of[me] == piece[p]) for p in range(len(m))]
        recv_rows = [rows[s][of[s] == piece[me]] for s in range(len(m))]
        got = np.concatenate(recv_rows)
        order = np.argsort(got, kind="stable")
        if not np.array_equal(got[order],
                              piece[me] * n_piece + np.arange(n_piece)):
            raise AssertionError("legacy EP flow: the pieces do not tile "
                                 "the global batch")
        # home: the results of my sub-block from my own ep group's members
        mates = [p for p in range(len(m)) if replica[p] == replica[me]]
        back = [rows[q][of[q] == piece[me]] - piece[me] * n_piece
                if replica[q] == replica[me] else np.zeros(0, np.int64)
                for q in range(len(m))]
        came = np.concatenate([np.flatnonzero(of[me] == piece[p])
                               for p in mates])
        place = np.empty(n_sub, np.int64)
        place[came] = np.arange(n_sub)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                device)

        out_split = [int(len(s)) for s in send]
        in_split = [int(len(r)) for r in recv_rows]
        home_in = [int((of[me] == piece[p]).sum())
                   if replica[p] == replica[me] else 0
                   for p in range(len(m))]
        pairs, copies = copy_pairs(np.concatenate(send))
        return LegacyRoutes(
            send=tensor(pairs), copies=copies, send_splits=out_split,
            recv_splits=in_split, order=tensor(order),
            back=tensor(np.concatenate(back)),
            back_splits=[int(len(b)) for b in back], home_splits=home_in,
            home_order=tensor(place))


@dataclasses.dataclass(frozen=True)
class LegacyRoutes:
    """One call's exchanges (``core/collectives.py`` ``exchange_rows``):
    the sub-block's rows out to the members holding their pieces
    (``send``: pairs of the rows repeated ``copies`` times, ``send_splits``, ``recv_splits``, ``order``: the received
    rows in piece order), and each piece's results back to the members of
    this ep group whose sub-blocks hold them (``back``, ``back_splits``,
    ``home_splits``, ``home_order``: the received results in sub-block
    order)."""

    send: torch.Tensor
    send_splits: list
    recv_splits: list
    order: torch.Tensor
    back: torch.Tensor
    back_splits: list
    home_splits: list
    home_order: torch.Tensor
    # the copies of each row that ``send`` names (copy_pairs): one a
    # member whose piece holds the row
    copies: int = 1


@dataclasses.dataclass(frozen=True)
class ExpertParallelGroups:
    """What the EP path of a layer needs of the mesh: the ep ``group``
    (``None``: one rank), this rank's index on it and its size; the
    ``dup`` group over the ep axes that carry no tokens upstream (``tp``,
    ``cp_r``: their ranks hold the same tokens, and each takes its slice of
    them; ``None`` when there are none); and, for the legacy flow on a
    mesh where JAX's pieces are not the ranks' own blocks, ``legacy``."""

    group: object = None
    rank: int = 0
    world: int = 1
    dup_group: object = None
    legacy: "LegacyPieces | None" = None


_ONE_RANK = ExpertParallelGroups()


def bind_expert_parallel(module: nn.Module, ctx: MeshContext) -> None:
    """Give every :class:`MoELayer` of ``module`` with ``ep_axes`` its
    groups on ``ctx`` (collective: every rank calls it, in the same order).

    Token layout (``token_axes=(batch_axes, seq_axes)``): each rank
    dispatches its own ``[b_loc, t_loc]`` block; the ep axes outside the
    token axes subdivide it (``dup``). Legacy flow (``token_axes=None``):
    the JAX package flattens the global batch and cuts it over the ep
    axes, every ep group computing every piece; where that is not each
    rank's own (sub-)block (``cp_shard > 1``, or a batch axis larger than
    1 outside the ep axes) the layer regroups the rows of the pieces
    before its dispatch and sends the results home after it
    (:class:`LegacyPieces`), so the capacity sees JAX's pieces."""
    for name, layer in module.named_modules():
        if not isinstance(layer, MoELayer) or layer.ep_axes is None:
            continue
        axes = layer.ep_axes
        world = ctx.axis_size(*axes) if axes else 1
        if layer.num_experts % world:
            raise ValueError(f"{name}: num_experts {layer.num_experts} not "
                             f"divisible by ep size {world}")
        if layer.token_axes is None:
            batch, seq = tuple(ctx.batch_axes), tuple(ctx.sequence_axes)
        else:
            batch, seq = layer.token_axes
        carrying = set(batch) | set(seq)
        dup = tuple(a for a in axes
                    if a not in carrying and ctx.axis_size(a) > 1)
        legacy = None
        if layer.token_axes is None and ctx.mesh is not None:
            legacy = _legacy_pieces(ctx, batch, seq, axes, dup)
        layer._ep = ExpertParallelGroups(
            group=ctx.group(*axes) if world > 1 else None,
            rank=ctx.coordinate(*axes), world=world,
            dup_group=ctx.group(*dup) if dup else None, legacy=legacy)


def _legacy_pieces(ctx, batch, seq, ep_axes, dup) -> "LegacyPieces | None":
    over = set(batch) | set(seq) | set(ep_axes)
    axes = tuple(a for a in MESH_AXIS_NAMES
                 if a in over and ctx.axis_size(a) > 1)
    if not axes:
        return None
    sizes = {a: ctx.axis_size(a) for a in MESH_AXIS_NAMES}
    members = np.array(list(itertools.product(
        *[range(sizes[a]) for a in axes])), np.int64)
    group = ctx.group(*axes)
    rank = ctx.coordinate(*axes)
    if dist.get_rank(group) != rank:
        raise AssertionError(f"group over {axes}: rank {dist.get_rank(group)}"
                             f" at coordinate {rank}")
    return LegacyPieces(group=group, rank=rank, axes=axes, members=members,
                        sizes=sizes, batch_axes=tuple(batch),
                        seq_axes=tuple(seq), ep_axes=tuple(ep_axes),
                        dup_axes=dup)


def expert_parallel_layers(module: nn.Module) -> list[str]:
    """Names of the :class:`MoELayer` s of ``module`` built with
    ``ep_axes``."""
    return [n for n, m in module.named_modules()
            if isinstance(m, MoELayer) and m.ep_axes is not None]


def expert_ffn(weights, dtype: torch.dtype, moe_ffn: MoeFfn = "aligned"):
    """The EP path's expert compute over this rank's ``weights`` (gate, up,
    down ``[e_loc, ...]``): ``fn(rows, labels, group_sizes)`` runs the
    fused expert-FFN kernel ``moe_ffn`` on the received rows, one pair a
    row of local expert ``labels``, probs 1 → ``[rows, D]`` in their
    order (``ops/ep_dispatch.py``'s ``expert_fn``)."""
    gather, combine = MOE_FFN_VARIANTS[moe_ffn]
    e_loc = weights[0].shape[0]

    def fn(rows, labels, group_sizes):
        if rows.shape[0] == 0:
            # a result (and a gradient on the way back) all the same: the
            # return trip's collective runs on every rank
            return rows * 0
        sort = sort_tokens_by_expert(labels[:, None], e_loc)
        ones = torch.ones((rows.shape[0], 1), dtype=torch.float32,
                          device=rows.device)
        return fused_moe_ffn_apply(rows, ones, sort, *weights, dtype,
                                   num_experts=e_loc, gather=gather,
                                   combine=combine)

    return fn


def _local(w: torch.Tensor) -> torch.Tensor:
    """This rank's experts of a weight (a ``DTensor`` under
    ``fsdp_ep_plan``), differentiable."""
    return w.to_local() if hasattr(w, "to_local") else w


class MoELayer(nn.Module):
    """Router + expert-sorted dispatch + grouped experts + combine (+ shared
    expert), on the local path (``ep_axes=None``) or the expert-parallel
    one. Submodules ``router``, ``grouped_experts``,
    ``shared_expert_module`` — the JAX layer's names.

    ``moe_ffn`` selects the fused expert-FFN kernel the layer runs: the
    aligned one (``"aligned"``), the row-gathering one (``"gather"``) or the
    gathering and combining one (``"gather_combine"``) — see
    ``ops/moe_ffn.py``. Every value computes the same function; there is no
    unfused choice (the unfused chain is the kernels' backward and test
    oracle).
    """

    def __init__(
        self,
        hidden_dim: int,
        intermediate_dim_grouped: int,
        num_grouped_experts: int,
        top_k: int,
        *,
        router_renormalize_probabilities: bool = True,
        router_enable_expert_bias: bool = False,
        router_n_group: int = 1,
        router_topk_group: int = 1,
        shared_expert: Optional[SharedExpertParameters] = None,
        ep_axes: Optional[tuple[str, ...]] = None,
        token_axes=None,
        ep_capacity_factor: Optional[float] = None,
        routed_scaling: float = 1.0,
        moe_ffn: MoeFfn = "aligned",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if moe_ffn not in MOE_FFN_VARIANTS:
            raise ValueError(f"moe_ffn {moe_ffn!r} is not one of "
                             f"{sorted(MOE_FFN_VARIANTS)}")
        # ep_capacity_factor sizes the EP dispatch only; the local path
        # ignores it, as in the JAX package
        self.ep_axes = None if ep_axes is None else tuple(ep_axes)
        self.token_axes = (None if token_axes is None
                           else tuple(tuple(a) for a in token_axes))
        self.ep_capacity_factor = ep_capacity_factor
        self._ep = _ONE_RANK
        self.num_experts = num_grouped_experts
        self.routed_scaling = routed_scaling
        self.moe_ffn = moe_ffn
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.router = TopKRouter(
            hidden_dim, num_grouped_experts, top_k,
            renormalize_probabilities=router_renormalize_probabilities,
            enable_expert_bias=router_enable_expert_bias,
            n_group=router_n_group, topk_group=router_topk_group, **kw)
        self.grouped_experts = GroupedSwiGLU(
            hidden_dim, intermediate_dim_grouped, num_grouped_experts, **kw)
        self.shared_expert_module = (
            SharedSwiGLU(hidden_dim, shared_expert, **kw)
            if shared_expert is not None else None)
        self._stats_sink: list[torch.Tensor] | None = None

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """``[B, T, D]`` → ``[B, T, D]``."""
        shared = None
        if self.shared_expert_module is not None:
            shared = self.shared_expert_module(hidden)
        topk_ids, topk_probs = self.router(hidden)
        if self.ep_axes is None:
            out = self._forward_local(hidden, topk_ids, topk_probs)
        else:
            out = self._forward_ep(hidden, topk_ids, topk_probs)
        if self.routed_scaling != 1.0:
            # on the routed output only, as a scalar of the output's dtype
            scale = torch.tensor(self.routed_scaling, dtype=out.dtype)
            out = out * float(scale)
        if shared is not None:
            out = out + shared
        return out

    def _forward_local(self, hidden, topk_ids, topk_probs):
        shape, k = hidden.shape, topk_ids.shape[-1]
        sort = sort_tokens_by_expert(topk_ids.reshape(-1, k), self.num_experts)
        if self._stats_sink is not None:
            # the per-expert pair counts ARE the sort's group sizes
            self._stats_sink.append(sort.group_sizes)
        gather, combine = MOE_FFN_VARIANTS[self.moe_ffn]
        experts = self.grouped_experts
        return fused_moe_ffn_apply(
            hidden.reshape(-1, shape[-1]), topk_probs.reshape(-1, k), sort,
            experts.gate_proj, experts.up_proj, experts.down_proj, self.dtype,
            num_experts=self.num_experts, gather=gather, combine=combine,
        ).reshape(shape)

    def _forward_ep(self, hidden, topk_ids, topk_probs):
        """``hidden [B, T, D]``, ids/probs ``[B, T, K]`` → ``[B, T, D]``:
        this rank's block (its ``1/dup`` slice of it) dispatched over the
        ep group, its output gathered back over the dup group."""
        ep = self._ep
        if ep is _ONE_RANK and self.ep_axes:
            raise RuntimeError(
                f"MoELayer with ep_axes={self.ep_axes} has no mesh: build "
                f"the model through the model factory, or call "
                f"bind_expert_parallel(model, ctx)")
        shape, k = hidden.shape, topk_ids.shape[-1]
        ids = topk_ids.reshape(-1, k)
        if self._stats_sink is not None:
            # the whole block's counts: the dup slices hold the same tokens
            flat = ids.reshape(-1)
            self._stats_sink.append(torch.zeros(
                self.num_experts, dtype=torch.int64,
                device=ids.device).scatter_add_(0, flat, torch.ones_like(flat)))
        x = hidden.reshape(-1, shape[-1])
        probs = topk_probs.reshape(-1, k)
        if ep.dup_group is not None:
            x = split_to_group(x, ep.dup_group)
            probs = split_to_group(probs, ep.dup_group)
            ids = split_to_group(ids, ep.dup_group)  # no gradient: a slice
        routes = (None if ep.legacy is None
                  else ep.legacy.routes(shape[0], shape[1], x.device))
        if routes is not None:
            # JAX's piece of the flattened global batch, in its row order
            x, probs, ids = (exchange_rows(
                t, routes.send, routes.send_splits, routes.recv_splits,
                routes.order, ep.legacy.group, copies=routes.copies)
                for t in (x, probs, ids))
        e_loc = self.num_experts // ep.world
        experts = self.grouped_experts
        weights = [_local(w) for w in (experts.gate_proj, experts.up_proj,
                                       experts.down_proj)]
        if weights[0].shape[0] != e_loc:
            raise ValueError(
                f"MoELayer: this rank holds {weights[0].shape[0]} experts, "
                f"the ep group of {ep.world} wants {e_loc}: cut the expert "
                f"weights with fsdp_ep_plan")
        out = ep_dispatch_compute_combine(
            x, ids, probs, expert_ffn(weights, self.dtype, self.moe_ffn),
            group=ep.group, ep_rank=ep.rank, e_loc=e_loc,
            capacity_factor=self.ep_capacity_factor)
        if routes is not None:
            out = exchange_rows(out, routes.back, routes.back_splits,
                                routes.home_splits, routes.home_order,
                                ep.legacy.group)
        out = gather_from_group(out, ep.dup_group)
        return out.reshape(shape).to(hidden.dtype)


__all__ = [
    "ExpertParallelGroups",
    "GroupedSwiGLU",
    "LegacyPieces",
    "LegacyRoutes",
    "MoELayer",
    "SharedExpertParameters",
    "SharedSwiGLU",
    "TopKRouter",
    "bind_expert_parallel",
    "collect_tokens_per_expert",
    "expert_ffn",
    "expert_parallel_layers",
    "grouped_swiglu_apply",
    "top_k_indices",
]
