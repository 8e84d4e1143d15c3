"""Grouped-query attention block and its decode caches (counterpart of
``d9d_tpu/nn/attention.py``: ``GroupedQueryAttention`` with the contiguous
and the paged branches of ``_decode_attend``, the heads-major cache append
into a slot cache or a page pool (int8 with per-slot scales under
``kv_quant``), the slot-mask helpers and the prefill segments).

QKV projections → optional per-head QK RMSNorm → (optionally partial) RoPE →
pluggable SDPA backend → optional sigmoid output gate → output projection.

Where the JAX module keeps its KV cache in flax's mutable ``"cache"``
collection, the port keeps it in an explicit :class:`DecodeCache` (or, for
the paged serving loop, :class:`PagedDecodeCache`) that the caller
(``loop/generate.py``, ``loop/serve.py``) owns and passes in. The cache is
UPDATED IN PLACE. Every layer shares ONE write index tensor, which the model
advances once per call (not once per layer); a paged cache's layers also
share ONE page table (the JAX serving loop seeds an identical
``page_table`` leaf per module scope).

The decode contracts the JAX module asserts through ``checkify`` (the
multi-token fast path needs an empty cache; the cache must not overflow)
are static knowledge of the callers here and are checked on their host side,
so no layer ever reads a device scalar back.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.decode_flags import (
    PAGED_SCALE_SUFFIX,
    in_continuation_chunk,
    map_page_table,
    paged_pool_shape,
)
from d9d_tpu_torch.nn.linear import Projection
from d9d_tpu_torch.nn.logical_axes import EMBED, HEADS, KV_HEADS
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import RopeStyle, apply_rope
from d9d_tpu_torch.ops.attention.decode import flash_decode_attention
from d9d_tpu_torch.ops.attention.eager import eager_sdpa
from d9d_tpu_torch.parallel.shards import local_tensor, model_group


@dataclasses.dataclass
class LayerKVCache:
    """One layer's view of the decode cache: heads-major ``k``/``v``
    ``[B, Hkv, S, D]`` (the flash-decode kernel's streaming layout) and the
    write index shared by all layers — a 0-dim int32 tensor (one shared
    index: the closed-batch generate loop) or per-row ``[B]`` (continuous
    batching: each row's cache fills at its own rate)."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    # where this call's T new tokens go: int64 slots ``[T]`` (shared index)
    # or ``[B, T]`` (per-row), and the batch-row selector ``[B, 1]`` the
    # per-row write needs — computed once per model call, not once per layer.
    # Paged: ``slots`` is each row's slot within its page ``[B]`` and
    # ``rows`` the pool page that slot lies in ``[B]``.
    slots: torch.Tensor
    rows: torch.Tensor
    # paged mode only: k/v are pools ``[P, Hkv, page_size, D]`` read through
    # ``page_table [B, n_pages]``; int8 pools carry ``[P, Hkv, page_size]``
    # f32 scales
    page_table: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_length(self) -> int:
        return self.k.shape[2]


class DecodeCache:
    """KV slot cache of a whole model: per-layer heads-major buffers plus
    ONE write index. Owned by the caller and updated in place.

    ``per_row=True`` makes the index ``[B]`` (the serving loop); otherwise
    it is a 0-dim tensor. The index lives on the device and is never read
    back by the model. Move it through :meth:`advance`, :meth:`pin_index`
    and :meth:`zero_rows` (or write it directly only between model calls,
    after one of them): the write slots of a call are derived from it once
    and shared by all layers until one of these methods runs.
    """

    def __init__(
        self,
        num_layers: int,
        batch_size: int,
        num_kv_heads: int,
        max_length: int,
        head_dim: int,
        *,
        dtype: torch.dtype,
        device: "torch.device | str | None" = None,
        per_row: bool = False,
    ):
        dev = resolve_device(device)
        shape = (batch_size, num_kv_heads, max_length, head_dim)
        self.keys = [torch.zeros(shape, dtype=dtype, device=dev)
                     for _ in range(num_layers)]
        self.values = [torch.zeros(shape, dtype=dtype, device=dev)
                       for _ in range(num_layers)]
        self.index = torch.zeros(
            (batch_size,) if per_row else (), dtype=torch.int32, device=dev
        )
        self.batch_size = batch_size
        self.max_length = max_length
        self._rows = torch.arange(batch_size, device=dev)[:, None]
        self._slots = None  # memo of the current call's write slots

    def layer(self, i: int, t: int) -> LayerKVCache:
        """Layer ``i``'s buffers plus the slots the next ``t`` tokens are
        written to (derived from the write index once, then shared by every
        layer until the index moves)."""
        if self._slots is None or self._slots.shape[-1] != t:
            steps = torch.arange(t, device=self.index.device)
            base = self.index.to(torch.int64)
            self._slots = (
                base + steps if base.ndim == 0
                else base[:, None] + steps[None, :]
            )
        return LayerKVCache(
            self.keys[i], self.values[i], self.index, self._slots, self._rows
        )

    def advance(self, t: int) -> None:
        """Move the shared write index past the ``t`` tokens just written
        (in place)."""
        self.index.add_(t)
        self._slots = None

    def pin_index(self, live: torch.Tensor) -> None:
        """Pin dead/idle rows' write indices to 0 (in place): the step
        advances every row's index, so without the pin a long-idle slot
        would climb past capacity and defeat the flash-decode block skip."""
        self.index.mul_(live.to(self.index.dtype))
        self._slots = None

    def zero_rows(self, rows: list[int]) -> None:
        """Zero the cache and the write index of the given batch rows (in
        place). The row list is host knowledge, so no device mask is
        scanned and only the named rows are touched."""
        for r in rows:
            for buf in (*self.keys, *self.values):
                buf[r].zero_()
            if self.index.ndim:
                self.index[r] = 0
        self._slots = None


def _paged_slot(page_table: torch.Tensor, start: torch.Tensor,
                page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise (page, offset) for logical slot ``start [B]``: the page id
    gathered from the table, the offset within it. Dead/idle rows (their
    ``start`` and table row pinned to 0) land on the garbage page."""
    start = start.to(torch.int64)
    page = page_table.gather(1, (start // page_size)[:, None])[:, 0]
    return page.to(torch.int64), start % page_size


class PagedDecodeCache:
    """Paged KV cache of a whole model (counterpart of the pools, scale
    pools and page tables ``_init_cache`` of ``d9d_tpu/loop/serve.py`` seeds
    in place of the dense cache leaves): per layer, heads-major page pools
    ``[num_pages, Hkv, page_size, D]`` for k and v — int8, with f32
    ``[num_pages, Hkv, page_size]`` scale pools beside them, when
    ``kv_quant="int8"`` — ONE ``page_table [B, pages_per_row]`` int32
    shared by every layer, and the per-row write index ``[B]``. Owned by
    the serving loop, which fills the table from its host allocator
    (``loop/kv_paging.py``); updated in place. Page 0 is the garbage page.

    ``pools`` is keyed by the JAX package's cache leaf names
    (``cached_key``, ``cached_value`` and their ``_scale`` siblings).
    """

    # per-row cache state that pages cannot restore (the reference's GDN
    # recurrent state and conv tails); none in the ported models
    unpageable_leaves: tuple = ()

    def __init__(
        self,
        num_layers: int,
        batch_size: int,
        num_kv_heads: int,
        max_length: int,
        head_dim: int,
        *,
        page_size: int,
        num_pages: int,
        dtype: torch.dtype,
        kv_quant: Optional[str] = None,
        device: "torch.device | str | None" = None,
    ):
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        dev = resolve_device(device)
        dense = (batch_size, num_kv_heads, max_length, head_dim)
        self.pools: dict[str, list[torch.Tensor]] = {}
        for leaf in ("cached_key", "cached_value"):
            shape = paged_pool_shape(dense, leaf, num_pages, page_size)
            self.pools[leaf] = [
                torch.zeros(shape, dtype=torch.int8 if kv_quant else dtype,
                            device=dev)
                for _ in range(num_layers)
            ]
            if kv_quant:
                # one scale per slot's feature vector: the pool shape minus
                # its feature dim, read through the same page table
                self.pools[leaf + PAGED_SCALE_SUFFIX] = [
                    torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                    for _ in range(num_layers)
                ]
        self.pages_per_row = -(-max_length // page_size)
        self.page_table = torch.zeros(
            (batch_size, self.pages_per_row), dtype=torch.int32, device=dev)
        self.index = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        self.batch_size = batch_size
        self.max_length = max_length
        self.page_size = page_size
        self.num_pages = num_pages
        # bytes one page holds over every layer's pools (scales included),
        # and what the dense layout would hold for the whole batch
        self.page_bytes = sum(
            x.nbytes for xs in self.pools.values() for x in xs) // num_pages
        self.dense_bytes = (2 * num_layers * batch_size * num_kv_heads
                            * max_length * head_dim * dtype.itemsize)
        self._write = None  # memo of the current call's (page, offset)

    def layer(self, i: int, t: int) -> LayerKVCache:
        """Layer ``i``'s pools, the shared table and the (page, offset) the
        next token of every row is written to (derived from the write index
        and the table once, then shared by every layer)."""
        if self._write is None:
            self._write = _paged_slot(
                self.page_table, self.index, self.page_size)
        page, off = self._write
        scale = self.pools.get("cached_key" + PAGED_SCALE_SUFFIX)
        return LayerKVCache(
            self.pools["cached_key"][i], self.pools["cached_value"][i],
            self.index, off, page, page_table=self.page_table,
            k_scale=None if scale is None else scale[i],
            v_scale=(None if scale is None else
                     self.pools["cached_value" + PAGED_SCALE_SUFFIX][i]),
        )

    def advance(self, t: int) -> None:
        self.index.add_(t)
        self._write = None

    def pin_index(self, live: torch.Tensor) -> None:
        """Pin dead/idle rows' write indices to 0 (in place)."""
        self.index.mul_(live.to(self.index.dtype))
        self._write = None

    def pin_page_table(self, live: torch.Tensor) -> None:
        """Pin dead/idle rows' page-table rows to the garbage page (in
        place): a row that dies mid-chunk keeps running steps, and with its
        index pinned to 0 it would otherwise write ``page_table[b, 0]`` — a
        freed page or a SHARED prefix page."""
        map_page_table(
            self, lambda pt: pt * live[:, None].to(pt.dtype))
        self._write = None

    def set_page_table(self, table: torch.Tensor) -> None:
        """Overwrite the device table with the host mirror ``table``
        (pinned host memory: an asynchronous copy, no synchronization)."""
        map_page_table(self, lambda _pt: table)
        self._write = None

    def reset_rows(self, row_mask: torch.Tensor, pos: torch.Tensor) -> None:
        """Move the write index of the ``row_mask`` rows to ``pos`` (in
        place): an admitted row resumes at the first token past its
        prefix-cache hit, an evicted one at 0. Pools are shared and never
        row-zeroed — stale page bytes lie behind the slot mask."""
        self.index.copy_(torch.where(row_mask, pos.to(self.index.dtype),
                                     self.index))
        self._write = None


def _paged_write_checks(start: torch.Tensor, t: int, mask) -> None:
    """The paged cache is a serving-loop construct: one token per row per
    step, no slot mask, per-row write indices. Anything else reaching a
    paged module is a caller bug — fail loudly, not approximately."""
    if t != 1:
        raise NotImplementedError(
            "paged decode caches serve single-token steps only (the "
            "serving loop teacher-forces prompts token-by-token); got "
            f"t={t}"
        )
    if mask is not None:
        raise NotImplementedError(
            "paged decode does not take a slot mask (paged rows are "
            "never left-padded)"
        )
    if start.ndim == 0:
        raise ValueError(
            "paged decode needs per-row [B] write indices (the serving "
            "loop seeds them); got a scalar cache index"
        )


def _quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of feature vectors: ``v [..., D]`` →
    ``(int8 [..., D], f32 scale [...])`` with scale = absmax/127 per
    leading index. An all-zero vector gets scale 0 and quantizes to exact
    zeros (garbage-page writes stay harmless)."""
    vf = v.float()
    scale = vf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(vf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _decode_cache_append_heads_major(
    buf: torch.Tensor, value: torch.Tensor, cache: LayerKVCache,
    scale_pool: Optional[torch.Tensor] = None,
) -> None:
    """Write ``value [B, T, H, D]`` at the cache's write slots of the
    heads-major buffer ``[B, H, S, D]``, IN PLACE. The slots stay on the
    device (an indexed write, no readback).

    Capacity contract: callers never feed more than ``S`` total tokens, and
    idle rows of a serving batch keep their index pinned in range — an index
    past the end is a device-side fault, not a clamp.

    Paged: ``buf`` is a heads-major pool ``[P, H, page_size, D]`` and the one
    new token of each row lands at its (page, offset); with ``scale_pool``
    the pool is int8 and the token is quantized per (row, head) on the way
    in, its scale landing in ``scale_pool [P, H, page_size]``."""
    if cache.page_table is not None:
        page, off = cache.rows, cache.slots
        # advanced indices split by a slice: the target dims are [B, H, D]
        if scale_pool is not None:
            qv, sc = _quantize_rows(value[:, 0])  # [B,H,D] i8, [B,H] f32
            buf[page, :, off, :] = qv
            scale_pool[page, :, off] = sc
        else:
            buf[page, :, off, :] = value[:, 0]
    elif cache.slots.ndim == 1:  # one shared write index
        buf.index_copy_(2, cache.slots, value.transpose(1, 2))
    else:  # per-row [B] write indices (continuous batching)
        # advanced indices split by a slice: result dims are [B, T, H, D]
        buf[cache.rows, :, cache.slots] = value


def _check_slot_mask(mask, s_max: int) -> None:
    """Shared decode mask contract: 4D broadcastable to ``[B, Hq, T, s_max]``
    with the key axis indexing CACHE SLOTS (``loop/generate.py`` passes
    ``[B, 1, 1, S_max]`` key validity for left-padded ragged prompts; slot
    order equals time order per row, so causality stays slot-based). 2D/3D
    token-position masks are rejected — their shape can coincide with the
    slot layout and silently mean the wrong thing."""
    if mask is not None and (mask.ndim != 4 or mask.shape[-1] != s_max):
        raise NotImplementedError(
            "decode mode accepts only a 4D [B, Hq, T, decode_max_length] "
            f"cache-slot mask (loop/generate.py's form); got "
            f"{tuple(mask.shape)}"
        )


def _decode_slot_mask(start, t: int, s_max: int, window_size, mask):
    """Slot-based causal (+window, +caller) mask for decode attention
    (mask contract: :func:`_check_slot_mask`). ``start`` scalar →
    ``[1, 1, t, s_max]``; per-row ``[B]`` → ``[B, 1, t, s_max]``."""
    _check_slot_mask(mask, s_max)
    dev = start.device
    if start.ndim == 0:
        q_abs = start + torch.arange(t, dtype=torch.int32, device=dev)[:, None]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=dev)[None, :]
        dec_mask = (k_pos <= q_abs)[None, None]  # [1, 1, t, s_max]
        if window_size is not None:
            dec_mask = dec_mask & (k_pos > q_abs - window_size)[None, None]
    else:
        q_abs = (
            start[:, None, None]
            + torch.arange(t, dtype=torch.int32, device=dev)[None, :, None]
        )  # [B, t, 1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=dev)[None, None, :]
        dec_mask = (k_pos <= q_abs)[:, None]  # [B, 1, t, s_max]
        if window_size is not None:
            dec_mask = dec_mask & (k_pos > q_abs - window_size)[:, None]
    if mask is not None:
        dec_mask = dec_mask & mask
    return dec_mask


def _prefill_segments(mask, t: int, s_max: int) -> dict:
    """Segment-id kwargs expressing a slot-validity mask during a prefill
    that attends only the new tokens (left pads get id 0, real tokens 1 —
    real queries then never see pad keys; pad rows' outputs are don't-care
    positions discarded downstream, and stay finite because a pad row still
    sees the pad keys before it). Only the key-validity FORM
    ``[B, 1, 1, s_max]`` is expressible as segments, so head/query-varying
    masks are rejected rather than silently collapsed."""
    if mask is None:
        return {}
    _check_slot_mask(mask, s_max)
    if mask.shape[1] != 1 or mask.shape[2] != 1:
        raise NotImplementedError(
            "the decode prefill fast path supports only key-validity "
            f"masks [B, 1, 1, s_max]; got {tuple(mask.shape)}"
        )
    seg = mask[:, 0, 0, :t].to(torch.int32)
    return {"q_segments": seg, "kv_segments": seg}


class GroupedQueryAttention(nn.Module):
    """Parameters: ``q_proj``/``k_proj``/``v_proj``/``o_proj`` (and
    ``gate_proj`` with ``use_output_gate``) ``.weight [out, in]``,
    ``q_norm``/``k_norm`` ``.weight [head_dim]`` with ``qk_norm``, ``sinks
    [num_heads]`` with ``use_sinks``.

    Under tensor parallelism (``parallel/plan.py``) each rank computes its
    slice of the heads: the projections give it ``num_heads / tp`` query
    and ``num_kv_heads / tp`` kv heads, the sinks are cut the same way, and
    ``q_norm``/``k_norm``, shared by all heads, see only the rank's, so
    their gradients are summed over the tp group.

    ``decode_max_length > 0`` turns on KV-cache decode mode: ``forward``
    then needs a :class:`LayerKVCache`, writes the new k/v at the cache's
    write index (in place) and attends against the cache. The caller
    advances the shared index after the model call.
    """

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        num_kv_heads: int,
        head_dim: int,
        sdpa: SdpaBackend,
        *,
        qk_norm: bool = False,
        qk_norm_eps: float = 1e-6,
        qk_norm_zero_centered: bool = False,
        rope_style: RopeStyle = RopeStyle.HALF,
        rope_fraction: float = 1.0,
        use_sinks: bool = False,
        use_output_gate: bool = False,
        window_size: int | None = None,
        softmax_scale: float | None = None,
        fused_qkv: bool = False,
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if num_heads % num_kv_heads != 0:
            raise ValueError(
                f"num_heads {num_heads} not divisible by num_kv_heads "
                f"{num_kv_heads}"
            )
        rot = int(head_dim * rope_fraction)
        if rot % 2 != 0:
            raise ValueError(
                f"rotary dim must be even: head_dim={head_dim} * "
                f"rope_fraction={rope_fraction} gives {rot}"
            )
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.sdpa = sdpa
        self.qk_norm = qk_norm
        self.rope_style = rope_style
        self.rotary_dim = rot
        self.use_output_gate = use_output_gate
        self.window_size = window_size
        self.softmax_scale = softmax_scale
        self.fused_qkv = fused_qkv
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        h, hkv, d = num_heads, num_kv_heads, head_dim
        self.q_proj = Projection(hidden_size, h * d, axes=(EMBED, HEADS), **kw)
        self.k_proj = Projection(hidden_size, hkv * d, axes=(EMBED, KV_HEADS),
                                 **kw)
        self.v_proj = Projection(hidden_size, hkv * d, axes=(EMBED, KV_HEADS),
                                 **kw)
        if qk_norm:
            # in param_dtype, as the reference's q_norm/k_norm; the layer
            # norms around the block stay fp32 (nn/decoder.py)
            nkw = dict(eps=qk_norm_eps, zero_centered=qk_norm_zero_centered,
                       param_dtype=param_dtype or torch.float32, device=dev)
            self.q_norm = RMSNorm(d, **nkw)
            self.k_norm = RMSNorm(d, **nkw)
        self.sinks = None
        if use_sinks:
            self.sinks = nn.Parameter(
                torch.zeros(h, dtype=torch.float32, device=dev))
        if use_output_gate:
            self.gate_proj = Projection(hidden_size, h * d,
                                        axes=(EMBED, HEADS), **kw)
        self.o_proj = Projection(h * d, hidden_size, axes=(HEADS, EMBED), **kw)

    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.sinks is not None:
            with torch.no_grad():
                self.sinks.zero_()

    def logical_axes(self) -> dict:
        return {"sinks": (HEADS,)}

    def _rope(self, x, cos, sin):
        rot, d = self.rotary_dim, self.head_dim
        if not rot:
            return x
        cos_r, sin_r = cos[..., : rot // 2], sin[..., : rot // 2]
        if rot < d:
            # partial rotary: rotate the first `rot` dims, pass the rest
            return torch.cat(
                [apply_rope(x[..., :rot], cos_r, sin_r, self.rope_style),
                 x[..., rot:]],
                dim=-1,
            )
        return apply_rope(x, cos_r, sin_r, self.rope_style)

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[LayerKVCache] = None,
    ) -> torch.Tensor:
        b, t, _ = x.shape
        h, hkv, d = self.num_heads, self.num_kv_heads, self.head_dim

        if self.fused_qkv:
            # one matmul over a runtime weight concat: the activation rows
            # stream once instead of three times; same math, same parameters
            w = torch.cat(
                [self.q_proj.weight, self.k_proj.weight, self.v_proj.weight],
                dim=0,
            ).to(self.dtype)
            qkv = torch.nn.functional.linear(x.to(self.dtype), w)
            q = qkv[..., : h * d].reshape(b, t, h, d)
            k = qkv[..., h * d : (h + hkv) * d].reshape(b, t, hkv, d)
            v = qkv[..., (h + hkv) * d :].reshape(b, t, hkv, d)
        else:
            # the rank's heads: all of them, or its slice under tensor
            # parallelism
            q = self.q_proj(x).reshape(b, t, -1, d)
            k = self.k_proj(x).reshape(b, t, -1, d)
            v = self.v_proj(x).reshape(b, t, -1, d)
        h_loc = q.shape[2]

        if self.qk_norm:
            group = model_group(self.q_proj.weight)
            q = self.q_norm(q, grad_group=group)
            k = self.k_norm(k, grad_group=group)

        # one rotation over the q and k heads together (they share cos/sin):
        # half the elementwise launches of rotating them one after the other
        qk = self._rope(torch.cat([q, k], dim=2), cos, sin)
        q, k = qk[:, :, :h_loc], qk[:, :, h_loc:]
        sinks = None if self.sinks is None else local_tensor(self.sinks)

        if self.decode_max_length > 0:
            if cache is None:
                raise ValueError(
                    "decode mode (decode_max_length > 0) needs a LayerKVCache"
                )
            attn = self._decode_attend(q, k, v, mask, cache, t, sinks)
        else:
            attn = self.sdpa(
                q, k, v,
                causal=True,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=sinks,
                mask=mask,
            )

        out = attn.reshape(b, t, h_loc * d)
        if self.use_output_gate:
            out = out * torch.sigmoid(self.gate_proj(x))
        return self.o_proj(out)

    def _decode_attend(self, q, k, v, mask, cache: LayerKVCache, t: int,
                       sinks):
        """KV-cache attention: write the new k/v at the cache index (in
        place), then attend against the full static-length cache.

        A multi-token call outside a continuation chunk is the PREFILL fast
        path: the new tokens attend only themselves through the SDPA backend
        (the flash kernel) — valid only on an empty cache, which the caller
        guarantees. Everything else — single-token steps and continuation
        chunks of any size — attends the slot cache through the flash-decode
        kernel. A mask that is not of the key-validity form ``[B,1,1,S]``
        has no kernel: on the CPU it goes to :func:`eager_sdpa` with the
        slot mask, on a CUDA tensor it raises.

        A paged cache (:class:`PagedDecodeCache`, the serving loop's paged
        mode) takes single-token steps only: the token goes into its row's
        page (quantized under ``kv_quant``) and the step attends the pools
        through the paged flash-decode kernel.
        """
        s_max = self.decode_max_length
        start = cache.index
        if cache.page_table is not None:
            # paged serving mode (loop/serve.py): one token per row per
            # step, written into the pools and read back through the table
            _paged_write_checks(start, t, mask)
            _decode_cache_append_heads_major(
                cache.k, k.to(self.dtype), cache, cache.k_scale)
            _decode_cache_append_heads_major(
                cache.v, v.to(self.dtype), cache, cache.v_scale)
            return flash_decode_attention(
                q, cache.k, cache.v,
                start=start,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=sinks,
                page_table=cache.page_table,
                k_scale=cache.k_scale,
                v_scale=cache.v_scale,
            )
        if cache.max_length != s_max:
            raise ValueError(
                f"cache holds {cache.max_length} slots, module was built "
                f"with decode_max_length={s_max}"
            )
        _decode_cache_append_heads_major(cache.k, k.to(self.dtype), cache)
        _decode_cache_append_heads_major(cache.v, v.to(self.dtype), cache)
        if t > 1 and not in_continuation_chunk():
            return self.sdpa(
                q, k, v,
                causal=True,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=sinks,
                **_prefill_segments(mask, t, s_max),
            )
        key_validity_mask = mask is None or (
            mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
        )
        if key_validity_mask:
            _check_slot_mask(mask, s_max)
            return flash_decode_attention(
                q, cache.k, cache.v,
                start=start,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=sinks,
                kv_valid=None if mask is None else mask[:, 0, 0, :],
            )
        if q.device.type != "cpu":
            raise NotImplementedError(
                "decode attention with a mask beyond the key-validity form "
                "[B, 1, 1, S] has no kernel; only CPU tensors take the "
                "eager slot-mask path"
            )
        return eager_sdpa(
            q,
            cache.k.transpose(1, 2),
            cache.v.transpose(1, 2),
            causal=False,
            softmax_scale=self.softmax_scale,
            sinks=sinks,
            mask=_decode_slot_mask(start, t, s_max, self.window_size, mask),
        )
