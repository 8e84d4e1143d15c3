"""Expert-parallel token dispatch and combine over an all-to-all with split
sizes (counterpart of ``d9d_tpu/ops/ep_dispatch.py``).

Each of the W ranks of the expert-parallel group owns ``e_loc = E / W``
experts (rank ``i``: ``[i·e_loc, (i+1)·e_loc)``). One call, on every rank
of the group at once:

1. sort this rank's ``m = n·k`` (token, choice) pairs by global expert
   (``stable_expert_order``): the rows for each destination rank become
   one contiguous block;
2. all-gather the ``[E]`` count vector into ``S [W, E]`` on the host — ONE
   readback a call, counted in ``core.collectives.allgather_counts
   .readbacks``. From ``S`` every rank derives the same rows per (source,
   destination) ``R``, the same clamp ``A`` under a capacity, and every
   offset: ``all_to_all_single`` takes its splits as host ints;
3. the dispatch all-to-all of the kept rows (only real rows move);
4. label each received row with its local expert (a source's block is
   expert-sorted and a clamp cuts its tail) and run ``expert_fn`` on them;
5. the mirrored all-to-all brings each result home;
6. weight by the router probs and fold the ``k`` pairs of each token
   (``combine_pairs``).

The receive buffer holds just the received rows, where the JAX package
sizes it statically (``ep_buffer_rows``); every real row is computed as
there. Under a capacity the clamp is JAX's: earlier sources keep their
rows and the tail of a receiver's intake is cut; a dropped pair is never
sent, contributes exactly zero and gets a zero gradient. Differentiable
end to end: the all-to-all's backward is the mirrored call
(``core/collectives.py`` ``all_to_all_rows``).
"""

import math
from collections.abc import Callable
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from d9d_tpu_torch.core import collectives
from d9d_tpu_torch.core.collectives import all_to_all_rows, allgather_counts
from d9d_tpu_torch.ops.moe import (
    combine_pairs,
    pair_rows,
    stable_expert_order,
)

__all__ = ["EpPlan", "ep_buffer_rows", "ep_dispatch_compute_combine",
           "reset_counters"]


def ep_buffer_rows(rows_per_shard: int, ep_world: int,
                   capacity_factor: Optional[float]) -> int:
    """The JAX package's static receive-buffer rows: the dropless worst
    case ``rows · W``, or ``ceil(rows · factor)`` rounded up to 8. Under a
    capacity it is the most rows a rank takes in."""
    if capacity_factor is None:
        return rows_per_shard * ep_world
    return ((math.ceil(rows_per_shard * capacity_factor) + 7) // 8) * 8


def _excl_cumsum(x: np.ndarray, axis: int = 0) -> np.ndarray:
    return np.cumsum(x, axis=axis) - x


class EpPlan:
    """The host plan of one dispatch, derived from ``S [W, E]`` alike on
    every rank (``me``: this rank's group index)."""

    def __init__(self, S: np.ndarray, me: int, e_loc: int, rows: int,
                 capacity_factor: Optional[float]):
        S = np.asarray(S, np.int64)
        w = S.shape[0]
        R = S.reshape(w, w, e_loc).sum(-1)  # rows src -> dst
        if capacity_factor is None:
            A = R
        else:
            room = np.maximum(ep_buffer_rows(rows, w, capacity_factor)
                              - _excl_cumsum(R, axis=0), 0)
            A = np.minimum(R, room)
        self.send = [int(a) for a in A[me]]
        self.recv = [int(a) for a in A[:, me]]
        self.dropped = int(R[me].sum() - A[me].sum())
        starts = _excl_cumsum(R[me])
        # sorted rows this rank sends: each destination's block, its tail
        # cut by the clamp
        self.kept = (None if not self.dropped else np.concatenate(
            [np.arange(s, s + a) for s, a in zip(starts, A[me])]
            + [np.zeros(0, np.int64)]).astype(np.int64))
        mine = S[:, me * e_loc:(me + 1) * e_loc]  # [W, e_loc]
        kcnt = np.clip(np.asarray(self.recv)[:, None]
                       - _excl_cumsum(mine, axis=1), 0, mine)
        self.labels = np.repeat(np.tile(np.arange(e_loc), w), kcnt.reshape(-1))
        self.group_sizes = kcnt.sum(0)


def ep_dispatch_compute_combine(
    x: torch.Tensor,
    ids: torch.Tensor,
    probs: torch.Tensor,
    expert_fn: Callable[[torch.Tensor, torch.Tensor, list[int]], torch.Tensor],
    *,
    group,
    ep_rank: int,
    e_loc: int,
    capacity_factor: Optional[float],
) -> torch.Tensor:
    """``x [n, D]`` tokens, ``ids``/``probs [n, k]`` (global expert ids) →
    ``[n, D]``: each pair computed by its expert's owner in ``group``
    (``None``: one rank owning all ``e_loc`` experts), weighted by its prob
    and summed per token. ``expert_fn(rows [r, D], labels [r] int64 on the
    device, group_sizes [e_loc] host ints)`` runs this rank's experts on
    the received rows in the order they came and returns ``[r, D]``; the
    probs are applied after the return trip, as in the JAX package.
    Counts the call's dropped pairs (``.dropped_pairs``), the bytes it
    dispatches (``.dispatched_bytes``: the rows sent out, this rank's own
    included), received rows (``.recv_rows_*``) and calls."""
    n, k = ids.shape
    m = n * k
    world = 1 if group is None else dist.get_world_size(group)
    order, pair_dest, counts = stable_expert_order(ids.reshape(-1),
                                                   e_loc * world)
    S = allgather_counts(counts, group)
    plan = EpPlan(S, ep_rank, e_loc, m, capacity_factor)
    sent = order
    if plan.kept is not None:
        kept = torch.from_numpy(plan.kept).to(x.device)
        sent = order.index_select(0, kept)
    rows = pair_rows(x, k, sent)
    recv = all_to_all_rows(rows, plan.recv, plan.send, group)
    labels = torch.from_numpy(plan.labels).to(x.device)
    y = expert_fn(recv, labels, [int(g) for g in plan.group_sizes])
    home = all_to_all_rows(y, plan.send, plan.recv, group)
    if plan.kept is not None:
        # dropped pairs were never sent: their rows stay exactly zero
        home = home.new_zeros((m,) + tuple(home.shape[1:])).index_copy(
            0, kept, home)
    weighted = home * probs.reshape(-1).index_select(0, order)[:, None].to(
        home.dtype)
    _count(plan, recv.shape[0], rows.numel() * rows.element_size())
    return combine_pairs(weighted, pair_dest, n)


def _count(plan: EpPlan, recv_rows: int, sent_bytes: int) -> None:
    f = ep_dispatch_compute_combine
    f.calls += 1
    f.dropped_pairs += plan.dropped
    f.dispatched_bytes += sent_bytes
    f.recv_rows_sum += recv_rows
    f.recv_rows_min = min(f.recv_rows_min, recv_rows)
    f.recv_rows_max = max(f.recv_rows_max, recv_rows)


def reset_counters() -> None:
    """Zero the dispatch's counters (and the collectives' it reads)."""
    f = ep_dispatch_compute_combine
    f.calls = f.dropped_pairs = f.recv_rows_sum = f.recv_rows_max = 0
    f.dispatched_bytes = 0
    f.recv_rows_min = math.inf
    collectives.allgather_counts.readbacks = 0
    collectives.allgather_counts.seconds = 0.0
    a2a = collectives.all_to_all_rows
    a2a.calls = a2a.bytes_sent = a2a.host_staged_bytes = 0
    a2a.seconds = 0.0


reset_counters()
