"""Point-to-point transfers of carries and cotangents between the ranks
that own adjacent pipeline stages (counterpart of
``d9d_tpu/pipelining/runtime/transfer.py``, whose ``put_compat`` moves
arrays between stage submeshes under JAX's single controller; here each
rank is a process and the reference's batched ``isend``/``irecv`` move
them).

Channels: one process group of two ranks for each DIRECTED pair of pp
ranks that a program connects (at each coordinate of the other axes), so
traffic from ``a`` to ``b`` never queues behind traffic from ``b`` to
``a`` on one NCCL stream. On a channel the receiver takes the messages in
the order the sender's program sends them (every program is known to every
rank): a Recv action whose message is not yet there receives the
channel's earlier messages first and keeps them. Sends are eager (their
works are waited for at the end of the step), receives block: the
execution model ``program/validate.py`` proves deadlock-free, and taking
a channel's messages in send order never waits longer than the wanted one.

Each message is one ``dist.batch_isend_irecv`` of one flat byte buffer
holding the tree's tensors. Across a gloo group CUDA tensors go through
pinned host memory (as ``ops/attention/ring.py`` rotates the ring); on an
NCCL group they go directly. Shapes come from :class:`CarrySpec` s that
the engine fixes once from the first microbatch's forward chain. A
transfer that fails raises. ``p2p_counters`` counts calls, bytes sent and
received, bytes staged through the host and host seconds, as
``all_to_all_rows`` does.
"""

import dataclasses
import math
import time

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from d9d_tpu_torch.core.collectives import staging_buffer, stages_through_host
from d9d_tpu_torch.pipelining.program.actions import (
    BackwardRecv,
    BackwardSend,
    Compose,
    ForwardRecv,
    ForwardSend,
)


class _Counters:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.host_staged_bytes = 0
        self.seconds = 0.0


p2p_counters = _Counters()


@dataclasses.dataclass(frozen=True)
class CarrySpec:
    """A carry tree's structure (``pytree.treespec_dumps``) and each tensor
    leaf's shape and dtype."""

    treedef: str
    shapes: tuple
    dtypes: tuple

    @staticmethod
    def of(tree) -> "CarrySpec":
        leaves, treedef = pytree.tree_flatten(tree)
        if not all(isinstance(t, torch.Tensor) for t in leaves):
            raise TypeError("a pipeline carry must be a tree of tensors")
        return CarrySpec(pytree.treespec_dumps(treedef),
                         tuple(tuple(t.shape) for t in leaves),
                         tuple(t.dtype for t in leaves))

    @property
    def nbytes(self) -> int:
        return sum(math.prod(s) * d.itemsize
                   for s, d in zip(self.shapes, self.dtypes))

    def unpack(self, flat: torch.Tensor):
        out, off = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            n = math.prod(shape) * dtype.itemsize
            out.append(flat[off:off + n].view(dtype).view(shape))
            off += n
        return pytree.tree_unflatten(out, pytree.treespec_loads(self.treedef))


def message_key(action) -> tuple:
    """The message a Send/Recv action moves: ``("F", s, mb)`` for stage
    ``s``'s forward output (``ForwardSend(s)``, ``ForwardRecv(s + 1)``),
    ``("B", s, mb)`` for the gradient of stage ``s``'s input
    (``BackwardSend(s)``, ``BackwardRecv(s - 1)``)."""
    s, mb = action.stage, action.microbatch
    if isinstance(action, ForwardSend):
        return "F", s, mb
    if isinstance(action, ForwardRecv):
        return "F", s - 1, mb
    if isinstance(action, BackwardSend):
        return "B", s, mb
    if isinstance(action, BackwardRecv):
        return "B", s + 1, mb
    raise TypeError(f"not a transfer action: {action!r}")


def channel_orders(program, stage_owner) -> dict:
    """``{(src, dst): [message keys]}`` in the order each rank's program
    sends them."""
    orders: dict = {}

    def walk(rank, action):
        if isinstance(action, Compose):
            for a in action.actions:
                walk(rank, a)
        elif isinstance(action, ForwardSend):
            dst = stage_owner[action.stage + 1]
            orders.setdefault((rank, dst), []).append(message_key(action))
        elif isinstance(action, BackwardSend):
            dst = stage_owner[action.stage - 1]
            orders.setdefault((rank, dst), []).append(message_key(action))

    for rank in sorted(program):
        for action in program[rank]:
            walk(rank, action)
    return orders


def build_channels(pp: int, world: int, rank: int, pairs) -> dict:
    """The groups of the directed pp-rank ``pairs`` at this rank's
    coordinate of the other axes (collective: every rank creates every
    channel group of every coordinate, in one order). Mesh ranks are
    row-major with ``pp`` outermost: pp rank ``i`` at other-axes index
    ``c`` is global rank ``i · world / pp + c``."""
    n = world // pp
    mine = rank % n
    out = {}
    for a, b in sorted(pairs):
        for c in range(n):
            group = dist.new_group([a * n + c, b * n + c])
            if c == mine:
                out[(a, b)] = group
    return out


class P2PTransfer:
    """This rank's sends and receives of one program.

    ``peers``: pp rank → global rank; ``groups``: ``(src, dst)`` → the
    channel's group; ``orders``: :func:`channel_orders`; ``spec_in[s]``:
    the :class:`CarrySpec` of stage ``s``'s input carry (``s >= 1``)."""

    def __init__(self, *, pp_rank: int, peers: dict, groups: dict,
                 orders: dict, spec_in: dict, device: torch.device):
        self.rank = pp_rank
        self.peers = peers
        self.groups = groups
        self.orders = {k: v for k, v in orders.items() if self.rank in k}
        self.spec_in = spec_in
        self.device = device
        self._pos: dict = {}
        self._arrived: dict = {}
        self._inflight: list = []
        self._free: dict = {}

    def _spec(self, key) -> CarrySpec:
        kind, s, _ = key
        return self.spec_in[s + 1 if kind == "F" else s]

    def begin_step(self) -> None:
        self._pos = {ch: 0 for ch in self.orders}
        self._arrived = {}

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        free = self._free.get(nbytes)
        if free:
            return free.pop()
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def send(self, key, tree, dst: int) -> None:
        t0 = time.perf_counter()
        group = self.groups[(self.rank, dst)]
        leaves = pytree.tree_leaves(tree)
        device = leaves[0].device
        host = stages_through_host(group, device)
        flats = [t.detach().contiguous().view(-1).view(torch.uint8)
                 for t in leaves]
        total = sum(f.numel() for f in flats)
        if host:
            buf = self._host_buffer(total)
        elif len(flats) == 1:
            buf = flats[0]
        else:
            buf = torch.empty(total, dtype=torch.uint8, device=device)
        if buf is not flats[0] or len(flats) > 1:
            off = 0
            for f in flats:
                buf[off:off + f.numel()].copy_(f)
                off += f.numel()
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, buf, self.peers[dst], group)])
        self._inflight.append((works, buf, host))
        p2p_counters.calls += 1
        p2p_counters.bytes_sent += total
        p2p_counters.host_staged_bytes += total if host else 0
        p2p_counters.seconds += time.perf_counter() - t0

    def recv(self, key, src: int):
        ch = (src, self.rank)
        order = self.orders.get(ch, ())
        while key not in self._arrived:
            pos = self._pos.get(ch, 0)
            if pos >= len(order):
                raise RuntimeError(f"pipeline transfer: {key} is not sent on "
                                   f"channel {ch}")
            self._pos[ch] = pos + 1
            nxt = order[pos]
            self._arrived[nxt] = self._recv_one(nxt, src)
        return self._arrived.pop(key)

    def _recv_one(self, key, src: int):
        t0 = time.perf_counter()
        spec = self._spec(key)
        group = self.groups[(src, self.rank)]
        host = stages_through_host(group, self.device)
        total = spec.nbytes
        buf = (staging_buffer("pp_recv", total, torch.uint8, self.device,
                              True) if host else
               torch.empty(total, dtype=torch.uint8, device=self.device))
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, buf, self.peers[src], group)]):
            work.wait()
        if host:
            buf = buf.to(self.device, copy=True)
        p2p_counters.calls += 1
        p2p_counters.bytes_received += total
        p2p_counters.host_staged_bytes += total if host else 0
        p2p_counters.seconds += time.perf_counter() - t0
        return spec.unpack(buf)

    def finish(self) -> None:
        """Wait for every send of the step; the staged buffers go back to
        the pool."""
        t0 = time.perf_counter()
        for works, buf, host in self._inflight:
            for work in works:
                work.wait()
            if host:
                self._free.setdefault(buf.numel(), []).append(buf)
        self._inflight = []
        leftover = [k for k in self._arrived]
        p2p_counters.seconds += time.perf_counter() - t0
        if leftover:
            raise RuntimeError(f"pipeline transfer: messages received and "
                               f"never used: {leftover}")


__all__ = ["CarrySpec", "P2PTransfer", "build_channels", "channel_orders",
           "message_key", "p2p_counters"]
