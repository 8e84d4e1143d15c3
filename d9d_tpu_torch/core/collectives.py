"""Collectives over a process group (counterpart of
``d9d_tpu/core/collectives.py``): the sum all-reduce of a list of tensors
and the broadcast of a list of tensors from the group's rank 0, both in
place; and the host collectives of metrics and objects
(:func:`host_allreduce`, :func:`host_allreduce_tree`,
:func:`host_allgather_object`, :func:`host_broadcast_object`,
:func:`allgather_variadic`), which take and return numpy arrays or Python
objects. ``group=None`` means the default group; with no process group, or
a group of one, the host collectives return their input.

Tensor parallelism's collectives inside the model are autograd pairs,
Megatron's ``f`` and ``g`` (:func:`copy_to_group`: identity forward, sum
backward; :func:`reduce_from_group`: sum forward, identity backward), and
:func:`all_reduce_max_`; there ``group=None`` means no group (the tensor
itself).

Expert parallelism's collectives are :func:`all_to_all_rows` (rows to
their owners in splits given as host ints; its backward is the mirrored
call), :func:`exchange_rows` (chosen rows of this rank to chosen ranks,
a row to several of them, and the received rows put in a given order:
the legacy flow's regrouping of the global batch), :func:`allgather_counts`
(every rank's ``[E]`` count vector, read back to the host once) and the
pair that lets ranks holding the same tokens (``tp``, ``cp_r``) each take
a slice of them: :func:`split_to_group` (this rank's slice forward,
all-gather backward) and :func:`gather_from_group` (all-gather forward,
this rank's slice backward).

The JAX package names mesh axes inside ``shard_map``; the port names a
``torch.distributed`` group. Tensors travel in buckets of at most
``BUCKET_BYTES``: each bucket is one collective call on one flat buffer,
filled from and emptied back into the tensors. The buffer lies where the
group's backend takes it: on the tensors' device, or — for device tensors
on a gloo group, which moves host memory only — in pinned host memory, so
the device tensors cross through the host. The backend of the group
decides, as set by the caller of ``init_distributed``; nothing falls back.
"""

import math
import time
from enum import Enum
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 256 << 20

_buffers: dict[tuple, torch.Tensor] = {}


def stages_through_host(group, device: torch.device) -> bool:
    """Do tensors on ``device`` cross ``group`` through pinned host memory
    (a gloo group and a CUDA device)?"""
    return (device.type == "cuda"
            and dist.get_backend(group) == dist.Backend.GLOO)


def staging_buffer(name: str, numel: int, dtype: torch.dtype,
                   device: torch.device, host: bool) -> torch.Tensor:
    """A reusable flat buffer of at least ``numel`` elements, kept per
    (name, dtype, place): pinned host memory with ``host``, else on
    ``device``. Grows, never shrinks."""
    place = "host" if host else str(device)
    key = (name, dtype, place)
    buf = _buffers.get(key)
    if buf is None or buf.numel() < numel:
        if host:
            buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        else:
            buf = torch.empty(numel, dtype=dtype, device=device)
        _buffers[key] = buf
    return buf[:numel]


def _buckets(flats: list[torch.Tensor], cap: int):
    """Runs of (flat tensor, start, stop) of at most ``cap`` elements in
    all; a tensor larger than the room left is split across buckets."""
    bucket, used = [], 0
    for flat in flats:
        pos = 0
        while pos < flat.numel():
            n = min(flat.numel() - pos, cap - used)
            bucket.append((flat, pos, pos + n))
            used, pos = used + n, pos + n
            if used == cap:
                yield bucket, used
                bucket, used = [], 0
    if bucket:
        yield bucket, used


def _by_dtype(tensors):
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("collectives take contiguous tensors")
        groups.setdefault(t.dtype, []).append(t.view(-1))
    return groups


def _bucketed(name, tensors, group, call, fill, write_back):
    """Bucket by bucket: copy ``tensors`` into the staging buffer when
    ``fill``, run ``call(buffer)``, copy the buffer back into them when
    ``write_back``. Returns the bytes copied through the host."""
    staged = 0
    for dtype, flats in _by_dtype(tensors).items():
        device = flats[0].device
        host = stages_through_host(group, device)
        cap = max(1, BUCKET_BYTES // flats[0].element_size())
        total = sum(f.numel() for f in flats)
        buf = staging_buffer(name, min(cap, total), dtype, device, host)
        for bucket, used in _buckets(flats, cap):
            chunk, off = buf[:used], 0
            if fill:
                for flat, a, b in bucket:
                    chunk[off:off + b - a].copy_(flat[a:b])
                    off += b - a
            call(chunk)
            if write_back:
                off = 0
                for flat, a, b in bucket:
                    flat[a:b].copy_(chunk[off:off + b - a])
                    off += b - a
            if host:
                staged += used * chunk.element_size() * (fill + write_back)
    return staged


def all_reduce_sum(tensors: list[torch.Tensor], group=None) -> None:
    """Sum every tensor over ``group`` in place (every rank passes tensors
    of the same shapes and dtypes in the same order). Counts
    ``all_reduce_sum.calls``, ``host_staged_bytes`` (copied out to the host
    and back) and ``seconds`` (host time inside the call: the whole
    transfer when it is staged through the host, the enqueue only on a
    backend that takes device tensors)."""
    group = group or dist.group.WORLD
    t0 = time.perf_counter()
    all_reduce_sum.host_staged_bytes += _bucketed(
        "all_reduce", tensors, group,
        lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group),
        fill=True, write_back=True)
    all_reduce_sum.calls += 1
    all_reduce_sum.seconds += time.perf_counter() - t0


all_reduce_sum.calls = 0
all_reduce_sum.host_staged_bytes = 0
all_reduce_sum.seconds = 0.0


def broadcast(tensors: list[torch.Tensor], group=None, src: int = 0) -> None:
    """Overwrite every tensor with the group rank ``src``'s, in place."""
    group = group or dist.group.WORLD
    root = dist.get_global_rank(group, src)
    mine = dist.get_rank(group) == src
    broadcast.host_staged_bytes += _bucketed(
        "broadcast", tensors, group,
        lambda buf: dist.broadcast(buf, src=root, group=group),
        fill=mine, write_back=not mine)


broadcast.host_staged_bytes = 0


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce_sum([grad], ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce_sum([out], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``: a whole input
    (or weight) that each rank applies to its own part of the work, whose
    gradient is the sum of the ranks' parts (``None``: ``x`` itself)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, its gradient passed through as it is:
    each rank's partial result, summed into the whole one that every rank
    then holds, whose gradient is already whole on every rank (``None``:
    ``x`` itself)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, in place (no
    gradient: the callers use it as a shift that cancels; ``None``: ``x``
    itself)."""
    if group is not None:
        _bucketed("all_reduce", [x], group,
                  lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                                              group=group),
                  fill=True, write_back=True)
    return x


def _staged_call(name, send, recv_numel, group, call):
    """``call(send, recv)`` on the group's backend: on the tensors
    themselves, or through pinned host buffers for CUDA tensors on a gloo
    group (gloo moves host memory only, and its all-to-all and all-gather
    take no CUDA tensor). Returns the output and the bytes staged."""
    device = send.device
    if not stages_through_host(group, device):
        recv = torch.empty((recv_numel,), dtype=send.dtype, device=device)
        call(send, recv)
        return recv, 0
    host_in = staging_buffer(name + "_in", send.numel(), send.dtype, device,
                             True)
    host_in.copy_(send)
    host_out = staging_buffer(name + "_out", recv_numel, send.dtype, device,
                              True)
    call(host_in, host_out)
    recv = host_out.to(device, non_blocking=False)
    return recv, (send.numel() + recv_numel) * send.element_size()


def _all_to_all(x, out_splits, in_splits, group):
    """Rows of ``x [sum(in_splits), ...]`` to the group's ranks in order,
    ``in_splits[r]`` rows to rank ``r``; ``out_splits[r]`` rows come from
    rank ``r`` → ``[sum(out_splits), ...]``. Counts ``all_to_all_rows``'s
    calls, bytes, staged bytes and host seconds."""
    t0 = time.perf_counter()
    row = math.prod(x.shape[1:])
    flat = x.contiguous().view(-1)

    def call(send, recv):
        dist.all_to_all_single(recv, send, [n * row for n in out_splits],
                               [n * row for n in in_splits], group=group)

    out, staged = _staged_call("all_to_all", flat, sum(out_splits) * row,
                               group, call)
    all_to_all_rows.calls += 1
    all_to_all_rows.bytes_sent += flat.numel() * flat.element_size()
    all_to_all_rows.host_staged_bytes += staged
    all_to_all_rows.seconds += time.perf_counter() - t0
    return out.view(sum(out_splits), *x.shape[1:])


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, grad):
        out_splits, in_splits = ctx.splits
        return (_all_to_all(grad, in_splits, out_splits, ctx.group),
                None, None, None)


def all_to_all_rows(x: torch.Tensor, out_splits: list[int],
                    in_splits: list[int], group) -> torch.Tensor:
    """Differentiable all-to-all of rows with split sizes (host ints):
    ``in_splits[r]`` rows of ``x`` (in rank order) go to group rank ``r``,
    ``out_splits[r]`` rows come back from it, concatenated in rank order.
    The backward sends the gradient home: the same call with the splits
    swapped. ``group=None`` (one rank): ``x`` itself."""
    if group is None:
        return x
    return _AllToAllRows.apply(x, list(out_splits), list(in_splits), group)


all_to_all_rows.calls = 0
all_to_all_rows.bytes_sent = 0
all_to_all_rows.host_staged_bytes = 0
all_to_all_rows.seconds = 0.0


def copy_pairs(rows: np.ndarray) -> tuple[np.ndarray, int]:
    """Host row indices ``rows`` (a row may repeat) → ``(pairs, copies)``:
    ``copies`` is the most times a row repeats, and ``pairs[i] = rows[i] ·
    copies + j`` for the ``j``-th occurrence of ``rows[i]``, so no pair
    repeats (the ``send`` that :func:`exchange_rows` takes)."""
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return rows, 1
    order = np.argsort(rows, kind="stable")
    srt = rows[order]
    start = np.r_[0, np.flatnonzero(srt[1:] != srt[:-1]) + 1]
    run = np.repeat(start, np.diff(np.r_[start, srt.size]))
    occ = np.empty_like(rows)
    occ[order] = np.arange(srt.size) - run
    copies = int(occ.max()) + 1
    return rows * copies + occ, copies


def exchange_rows(x: torch.Tensor, send: torch.Tensor, send_splits,
                  recv_splits, order: torch.Tensor, group,
                  copies: int = 1) -> torch.Tensor:
    """Rows of ``x`` to the group's ranks in rank order, ``send_splits[r]``
    of them to rank ``r``; ``recv_splits[r]`` rows come from rank ``r``,
    and the received rows, concatenated in rank order, are returned in
    ``order`` (``recv[order]``). ``send`` names rows of ``x`` repeated
    ``copies`` times (row ``i``'s copy ``j`` is ``i · copies + j``;
    :func:`copy_pairs`), each at most once: a row sent to several ranks
    goes out as several copies. Differentiable: the gradient goes home
    through the mirrored all-to-all, and the gather's backward is a
    collision-free gather and one sum over each row's copies in a fixed
    order (as ``ops/moe.py`` ``pair_rows``), the same bits on every run,
    where a gather by repeated rows adds their gradients by atomics in the
    order they land on a card. ``send``, ``order``: int64 on ``x``'s
    device; splits: host ints."""
    n = x.shape[0]
    rows = (x if copies == 1 else x.unsqueeze(1).expand(
        n, copies, *x.shape[1:]).reshape(n * copies, *x.shape[1:]))
    rows = all_to_all_rows(rows.index_select(0, send), recv_splits,
                           send_splits, group)
    return rows.index_select(0, order)


def allgather_counts(counts: torch.Tensor, group) -> np.ndarray:
    """Every group rank's count vector ``[E]`` (int64, any device) →
    ``[W, E]`` int64 on the host, in group-rank order. ONE device-to-host
    readback, counted in ``allgather_counts.readbacks``: the vector itself
    when the group's backend moves host memory (gloo), the gathered matrix
    after an all-gather on the card otherwise (NCCL). ``group=None``: the
    vector alone, ``[1, E]``."""
    t0 = time.perf_counter()
    allgather_counts.readbacks += 1
    counts = counts.to(torch.int64)
    if group is None:
        out = counts.cpu().numpy()[None]
    else:
        world = dist.get_world_size(group)
        place = _backend_device(group)
        send = counts.to(place)
        recv = torch.empty(world * send.numel(), dtype=torch.int64,
                           device=place)
        dist.all_gather_into_tensor(recv, send, group=group)
        out = recv.cpu().numpy().reshape(world, -1)
    allgather_counts.seconds += time.perf_counter() - t0
    return out


allgather_counts.readbacks = 0
allgather_counts.seconds = 0.0


def _all_gather_rows(x, group):
    """``x [n, ...]`` of every group rank, concatenated in rank order."""
    world = dist.get_world_size(group)
    flat = x.contiguous().view(-1)

    def call(send, recv):
        dist.all_gather_into_tensor(recv, send, group=group)

    out, _ = _staged_call("all_gather", flat, world * flat.numel(), group,
                          call)
    return out.view(world * x.shape[0], *x.shape[1:])


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, parts):
        ctx.group = group
        n = x.shape[0] // parts
        return x[index * n:(index + 1) * n]

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.group), None, None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        ctx.index = dist.get_rank(group)
        return _all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        n, i = ctx.n, ctx.index
        return grad[i * n:(i + 1) * n], None


def split_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """This group rank's slice of rows of ``x`` (a whole tensor every rank
    of ``group`` holds alike; rows a multiple of the group's size): its
    ``1/W`` share, in rank order. The backward all-gathers the slices'
    gradients, so the whole gradient comes out on every rank
    (``None``: ``x`` itself)."""
    if group is None:
        return x
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"split_to_group: {x.shape[0]} rows over {world} "
                         f"ranks")
    return _SplitToGroup.apply(x, group, dist.get_rank(group), world)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's rows of ``x``, concatenated in rank order (the
    inverse of :func:`split_to_group`); the backward takes this rank's
    slice of the gradient, which every rank holds whole
    (``None``: ``x`` itself)."""
    return x if group is None else _GatherFromGroup.apply(x, group)


class ReduceOp(str, Enum):
    # no 'avg': averaging is not associative across uneven shards
    sum = "sum"
    max = "max"
    min = "min"


_DIST_OP = {ReduceOp.sum: dist.ReduceOp.SUM, ReduceOp.max: dist.ReduceOp.MAX,
            ReduceOp.min: dist.ReduceOp.MIN}


def _single(group) -> bool:
    return not dist.is_initialized() or dist.get_world_size(group) == 1


def _backend_device(group) -> torch.device:
    """Where the group's backend takes host collectives' tensors: the
    current card for NCCL, host memory for gloo."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_allreduce(value, op: ReduceOp = ReduceOp.sum,
                   group=None) -> np.ndarray:
    """Reduce a host array over ``group``; every rank passes an array of
    the same shape and dtype."""
    value = np.asarray(value)
    if _single(group):
        return value
    t = torch.from_numpy(np.ascontiguousarray(value)).to(
        _backend_device(group))
    dist.all_reduce(t, op=_DIST_OP[ReduceOp(op)], group=group)
    return t.cpu().numpy()


def host_allreduce_tree(tree, op: ReduceOp = ReduceOp.sum, group=None):
    """:func:`host_allreduce` over every leaf of nested dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return {k: host_allreduce_tree(v, op, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_allreduce_tree(v, op, group) for v in tree)
    return host_allreduce(tree, op, group)


def host_allgather_object(obj: Any, group=None) -> list[Any]:
    """Every rank's (picklable) ``obj``, in group-rank order."""
    if _single(group):
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def host_broadcast_object(obj: Any, root: int = 0, group=None) -> Any:
    """The group rank ``root``'s ``obj`` on every rank (the others may
    pass ``None``)."""
    if _single(group):
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group or dist.group.WORLD, root),
        group=group)
    return box[0]


def allgather_variadic(x, group=None) -> list[np.ndarray]:
    """Every rank's ``[n_i, ...]`` array, whose leading dims differ: shapes
    are exchanged first, the bytes padded to the longest, gathered in one
    collective and trimmed. Trailing dims and dtype must agree."""
    x = np.asarray(x)
    if _single(group):
        return [x]
    meta = host_allgather_object((x.shape, str(x.dtype)), group)
    if any(s[1:] != x.shape[1:] or d != str(x.dtype) for s, d in meta):
        raise ValueError(
            f"allgather_variadic needs matching trailing dims and dtype; "
            f"got {meta}")
    sizes = [math.prod(s) * x.dtype.itemsize for s, _ in meta]
    width = max(max(sizes), 1)
    payload = np.zeros(width, np.uint8)
    payload[:sizes[dist.get_rank(group)]] = np.ascontiguousarray(x).view(
        np.uint8).reshape(-1)
    place = _backend_device(group)
    out = torch.empty(len(meta) * width, dtype=torch.uint8, device=place)
    dist.all_gather_into_tensor(out, torch.from_numpy(payload).to(place),
                                group=group)
    rows = out.cpu().numpy().reshape(len(meta), width)
    return [np.frombuffer(rows[i, :n].tobytes(), dtype=x.dtype).reshape(s)
            for i, (n, (s, _)) in enumerate(zip(sizes, meta))]


__all__ = ["BUCKET_BYTES", "ReduceOp", "all_reduce_sum", "all_to_all_rows",
           "allgather_counts", "allgather_variadic", "broadcast",
           "copy_pairs", "exchange_rows", "gather_from_group", "host_allgather_object",
           "host_allreduce", "host_allreduce_tree", "host_broadcast_object",
           "split_to_group", "staging_buffer", "stages_through_host"]
