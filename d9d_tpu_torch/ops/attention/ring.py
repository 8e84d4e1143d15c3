"""Ring attention: context-parallel SDPA over the cp process group
(counterpart of ``d9d_tpu/ops/attention/ring.py``: ``ring_attention``,
``_ring_shape_checks``, ``_ring_flash``, ``_ring_eager``,
``make_ring_sdpa``).

Layout as in the JAX package: contiguous sequence chunks — rank ``i`` of
the ring owns positions ``[i·T_loc, (i+1)·T_loc)``. It keeps its query
chunk; the key/value chunks rotate, rank ``r`` sending to ``r+1``, so at
step ``s`` rank ``i`` holds the chunk of rank ``(i - s) mod cp`` and
attends it through the flash block at the chunks' global offsets (B4,
``flash.flash_attention``). The partial results merge by the logsumexp
combine; a learnable sink joins the global softmax denominator after the
loop. Packed-sequence ids of the key chunk rotate with it.

Gradient: the JAX package transposes ``ppermute`` inside ``lax.scan``.
Here one ``torch.autograd.Function`` spans the whole ring, so every rank
runs its point-to-point calls in one fixed order whatever autograd does.
Its forward returns ``(o, lse)`` before the sink fold and saves only the
local ``q, k, v``, that ``o`` and that ``lse``. Its backward recomputes
each step with the flash backward at the same offsets against the saved
global ``lse`` and ``delta = rowsum(do·o) - dlse`` (as ``_flash_ol_bwd``),
so each block's probabilities are the global ones — the gradient JAX's
chain rule through the combine gives. dq accumulates locally; each key
chunk's dk/dv accumulators travel with the chunk and are home after ``cp``
rotations. A rank whose query rows see no key of some chunk (ROADMAP C3)
gets ``p = exp(-1e30 - lse) = 0`` there, so nothing leaks.

Skipping: a chunk wholly in the causal future or wholly behind the window
is not launched (the offsets are host ints); merging it would change
nothing (its weight is exactly 0), and in the backward its gradients are
exactly 0. Its rotation still happens. Counted in
``ring_attention.skipped_blocks``. JAX rotates once more after the last
forward step; the port leaves that rotation out (nothing reads it), but
the backward's dk/dv accumulators take it: it brings them home.

Transport: one ``dist.batch_isend_irecv`` per rotation — one send to the
next rank, one receive from the previous — of one flat byte buffer that
holds every rotating tensor. On a gloo group device tensors cross through
pinned host memory (``ring_attention.host_staged_bytes`` counts the bytes
copied out and in); on an NCCL group they go directly. The group's
backend decides.

``impl``: ``"flash"`` (the default; the B4 kernels on CUDA tensors, their
plain versions on CPU tensors) or ``"eager"`` (the plain versions in fp32
on any device: the oracle for cross-checks). An argument only — nothing is
read from the environment.
"""

from collections.abc import Sequence

import torch
import torch.distributed as dist

from d9d_tpu_torch.core.collectives import staging_buffer, stages_through_host
from d9d_tpu_torch.core.mesh import AXIS_CP_SHARD, AXIS_TP, MeshContext
from d9d_tpu_torch.ops.attention import flash as F

IMPLS = ("flash", "eager")


class Ring:
    """This rank's place on the ring of ``group`` (``None``: a ring of one
    rank, no communication) and the rotation of the chunk tensors."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.rank = 1, 0
            return
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def rotate(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Send ``tensors`` to the next rank and return the previous rank's
        (same shapes and dtypes), as new tensors on the same device."""
        dev = tensors[0].device
        host = stages_through_host(self.group, dev)
        flats = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
        total = sum(f.numel() for f in flats)
        send = staging_buffer("ring_send", total, torch.uint8, dev, host)
        recv = staging_buffer("ring_recv", total, torch.uint8, dev, host)
        off = 0
        for f in flats:
            send[off:off + f.numel()].copy_(f)
            off += f.numel()
        ops = [dist.P2POp(dist.isend, send, self.next, self.group),
               dist.P2POp(dist.irecv, recv, self.prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out, off = [], 0
        for t, f in zip(tensors, flats):
            chunk = recv[off:off + f.numel()].to(dev, copy=True)
            out.append(chunk.view(t.dtype).view(t.shape))
            off += f.numel()
        if host:
            ring_attention.host_staged_bytes += 2 * total
        return out


def _ring_shape_checks(q, k, v):
    b, t_loc, hq, _ = q.shape
    _, s_loc, hkv, _ = v.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if t_loc != s_loc or k.shape[1] != s_loc:
        raise ValueError("ring attention requires equal q/kv shard lengths")


def _visible(q_offset, k_offset, t, causal, window_size) -> bool:
    """Does any query of the chunk at ``q_offset`` see a key of the chunk at
    ``k_offset`` by position (``_skip_block`` on whole chunks)?"""
    if causal and k_offset > q_offset + t - 1:
        return False
    if window_size is not None and k_offset + t - 1 <= q_offset - window_size:
        return False
    return True


def _steps(ring, t, kw):
    """(step s, the offsets, whether to run it) of each ring step: step s
    attends the chunk of rank ``(rank - s) mod size``; a chunk no query of
    this rank can see is counted in ``skipped_blocks`` and not run."""
    for s in range(ring.size):
        offs = dict(q_offset=ring.rank * t,
                    k_offset=(ring.rank - s) % ring.size * t)
        run = _visible(offs["q_offset"], offs["k_offset"], t, kw["causal"],
                       kw["window_size"])
        ring_attention.skipped_blocks += not run
        yield s, offs, run


def _block_fns(impl):
    """(forward, backward) of one ring step."""
    if impl == "flash":
        return F.flash_attention, F.flash_attention_bwd

    def fwd(q, k, v, **kw):
        ring_attention.eager_blocks += 1
        return F.flash_attention_plain(q.float(), k.float(), v.float(), **kw)

    def bwd(q, k, v, do, lse, delta, **kw):
        ring_attention.eager_blocks += 1
        return F.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           do.float(), lse, delta, **kw)

    return fwd, bwd


class RingFunction(torch.autograd.Function):
    """The whole ring as one differentiable function of the local ``q, k,
    v``: ``(o [B,T,Hq,D] fp32, lse [B,Hq,T])`` before the sink fold."""

    @staticmethod
    def forward(ctx, q, k, v, q_segments, kv_segments, ring, kw, impl):
        fwd, _ = _block_fns(impl)
        b, t, hq, d = q.shape
        o = torch.zeros((b, t, hq, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, hq, t), F.NEG_BIG, dtype=torch.float32,
                         device=q.device)
        q, k_blk, v_blk, ks_blk = q.detach(), k.detach(), v.detach(), kv_segments
        for s, offs, run in _steps(ring, t, kw):
            if run:
                o_blk, lse_blk = fwd(q, k_blk, v_blk, q_segments=q_segments,
                                     kv_segments=ks_blk, **offs, **kw)
                o, lse = F.combine_attention_chunks(o, lse, o_blk, lse_blk)
            if s < ring.size - 1:
                rotating = [k_blk, v_blk] + ([ks_blk] if ks_blk is not None
                                             else [])
                k_blk, v_blk, *rest = ring.rotate(rotating)
                ks_blk = rest[0] if rest else None
        ctx.save_for_backward(q, k, v, o, lse, q_segments, kv_segments)
        ctx.ring, ctx.kw, ctx.impl = ring, kw, impl
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        # o and lse were saved as outputs of the graph: detach for the kernels
        o, lse = o.detach(), lse.detach()
        ring, kw = ctx.ring, ctx.kw
        _, bwd = _block_fns(ctx.impl)
        t = q.shape[1]
        do = do.detach().to(q.dtype if ctx.impl == "flash"
                            else torch.float32).contiguous()
        delta = F.block_delta(do, o, dlse)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        q, k_blk, v_blk, ks_blk = q.detach(), k.detach(), v.detach(), kv_seg
        for s, offs, run in _steps(ring, t, kw):
            if run:
                dq_s, dk_s, dv_s = bwd(
                    q, k_blk, v_blk, do, lse, delta, q_segments=q_seg,
                    kv_segments=ks_blk, **offs, **kw)
                dq += dq_s
                dk += dk_s
                dv += dv_s
            if ring.size == 1:
                continue
            if s < ring.size - 1:
                # the next chunk arrives together with its accumulators
                rotating = [k_blk, v_blk, dk, dv] + (
                    [ks_blk] if ks_blk is not None else [])
                k_blk, v_blk, dk, dv, *rest = ring.rotate(rotating)
                ks_blk = rest[0] if rest else None
            else:
                # the last rotation brings each chunk's gradients home
                dk, dv = ring.rotate([dk, dv])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    sinks: torch.Tensor | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    impl: str = "flash",
) -> torch.Tensor:
    """Per-rank attention: ``q/k/v [B, T_loc, H(q|kv), D]`` → ``[B, T_loc,
    Hq, D]`` in q's dtype. Matches ``eager_sdpa`` on the gathered sequence
    (GQA, causal, sliding window, learnable sinks, packed segments), as the
    JAX ``ring_attention`` does. Every rank of ``group`` calls it with its
    own chunk (``None``: one rank). ``q_segments``/``kv_segments`` are this
    rank's ``[B, T_loc]`` slices of the global packed-sequence ids."""
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be provided together")
    if impl not in IMPLS:
        raise ValueError(f"unknown ring block impl {impl!r}")
    _ring_shape_checks(q, k, v)
    kw = dict(causal=causal, softmax_scale=softmax_scale,
              window_size=window_size)
    o, lse = RingFunction.apply(q, k, v, q_segments, kv_segments, Ring(group),
                                kw, impl)
    if sinks is not None:
        # the sink joins only the global softmax denominator (JAX ring.py:157):
        # o' = o / (1 + exp(sink - lse)); autograd gives dsinks and dlse
        z = torch.clamp(sinks.float()[None, :, None] - lse, max=60.0)
        o = o * (1.0 / (1.0 + torch.exp(z))).transpose(1, 2)[..., None]
    return o.to(q.dtype)


ring_attention.skipped_blocks = 0     # chunks not launched (fwd and bwd)
ring_attention.host_staged_bytes = 0  # rotation bytes through pinned memory
ring_attention.eager_blocks = 0       # blocks run by impl="eager" (fwd, bwd)


def make_ring_sdpa(
    ctx: MeshContext,
    *,
    seq_axis: str = AXIS_CP_SHARD,
    batch_axes: Sequence[str] = ("dp_r", "dp_s"),
    head_axes: Sequence[str] = ("tp",),
    impl: str = "flash",
):
    """An SDPA backend running ring attention over ``ctx``'s cp group.

    The JAX backend shard_maps global arrays; in the port every rank's model
    already holds its own rows and sequence chunk (the batch stager cut
    them) and, under tensor parallelism, its slice of the heads (the
    projections gave it ``h / tp`` query and ``hkv / tp`` kv heads), so the
    backend takes local ``[B_loc, T_loc, H_loc, D]`` tensors and the ring
    runs over this rank's ``cp_s`` group: each ``(dp_r, dp_s, cp_r, tp)``
    coordinate has its own ring, which moves only that rank's head slice of
    k and v, as JAX's ``qkv_spec`` does. ``batch_axes`` and ``head_axes``
    only name the axes the rows and heads were cut over; the divisibility
    JAX checks here is checked where the port cuts: rows by the batch axes
    (``BatchMaths``), the sequence by ``cp_s`` (``check_cp_seq_len``) and
    the heads by ``tp`` (``parallel/plan.py`` ``apply_plan``). The stager
    cuts the sequence over ``cp_s`` and the plan the heads over ``tp``
    only, so any other ``seq_axis``, or head axes other than ``tp`` of size
    > 1, raise.
    """
    other = {a: ctx.axis_size(a) for a in head_axes
             if a != AXIS_TP and ctx.axis_size(a) > 1}
    if other:
        raise NotImplementedError(
            f"ring attention over head axes {other}: heads are cut over "
            f"{AXIS_TP!r} only")
    if seq_axis != AXIS_CP_SHARD:
        raise NotImplementedError(
            f"ring attention over {seq_axis!r}: the batch is sequence-"
            f"sharded over {AXIS_CP_SHARD!r} only")
    if impl not in IMPLS:
        raise ValueError(f"unknown ring block impl {impl!r}")
    group = ctx.cp_group

    def ring_sdpa(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        *,
        causal: bool = True,
        softmax_scale: float | None = None,
        window_size: int | None = None,
        sinks: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        q_segments: torch.Tensor | None = None,
        kv_segments: torch.Tensor | None = None,
    ) -> torch.Tensor:
        if mask is not None:
            raise NotImplementedError(
                "ring attention does not support arbitrary masks; use the "
                "eager/flash backends or express the mask as causal+window"
            )
        return ring_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, sinks=sinks, q_segments=q_segments,
            kv_segments=kv_segments, group=group, impl=impl)

    ring_sdpa.group = group  # None: a ring of one rank
    return ring_sdpa


__all__ = ["IMPLS", "Ring", "RingFunction", "make_ring_sdpa",
           "ring_attention"]
