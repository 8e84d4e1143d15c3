"""Grouped-query attention block and its decode cache (counterpart of
``d9d_tpu/nn/attention.py``: ``GroupedQueryAttention`` with the contiguous
branch of ``_decode_attend``, the heads-major cache append, the slot-mask
helpers and the prefill segments).

QKV projections → optional per-head QK RMSNorm → (optionally partial) RoPE →
pluggable SDPA backend → optional sigmoid output gate → output projection.

Where the JAX module keeps its KV cache in flax's mutable ``"cache"``
collection, the port keeps it in an explicit :class:`DecodeCache` that the
caller (``loop/generate.py``, ``loop/serve.py``) owns and passes in. The
cache is UPDATED IN PLACE. Every layer shares ONE write index tensor, which
the model advances once per call (not once per layer).

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
from d9d_tpu_torch.nn.decode_flags import in_continuation_chunk
from d9d_tpu_torch.nn.linear import Projection
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import RopeStyle, apply_rope
from d9d_tpu_torch.ops.attention.decode import flash_decode_attention
from d9d_tpu_torch.ops.attention.eager import eager_sdpa


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
    # per-row write needs — computed once per model call, not once per layer
    slots: torch.Tensor
    rows: torch.Tensor

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


def _decode_cache_append_heads_major(
    buf: torch.Tensor, value: torch.Tensor, cache: LayerKVCache
) -> None:
    """Write ``value [B, T, H, D]`` at the cache's write slots of the
    heads-major buffer ``[B, H, S, D]``, IN PLACE. The slots stay on the
    device (an indexed write, no readback).

    Capacity contract: callers never feed more than ``S`` total tokens, and
    idle rows of a serving batch keep their index pinned in range — an index
    past the end is a device-side fault, not a clamp."""
    if cache.slots.ndim == 1:  # one shared write index
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
        self.q_proj = Projection(hidden_size, h * d, **kw)
        self.k_proj = Projection(hidden_size, hkv * d, **kw)
        self.v_proj = Projection(hidden_size, hkv * d, **kw)
        if qk_norm:
            nkw = dict(eps=qk_norm_eps, zero_centered=qk_norm_zero_centered,
                       device=dev)
            self.q_norm = RMSNorm(d, **nkw)
            self.k_norm = RMSNorm(d, **nkw)
        self.sinks = None
        if use_sinks:
            self.sinks = nn.Parameter(
                torch.zeros(h, dtype=torch.float32, device=dev))
        if use_output_gate:
            self.gate_proj = Projection(hidden_size, h * d, **kw)
        self.o_proj = Projection(h * d, hidden_size, **kw)

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
            q = self.q_proj(x).reshape(b, t, h, d)
            k = self.k_proj(x).reshape(b, t, hkv, d)
            v = self.v_proj(x).reshape(b, t, hkv, d)

        if self.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)

        # one rotation over the q and k heads together (they share cos/sin):
        # half the elementwise launches of rotating them one after the other
        qk = self._rope(torch.cat([q, k], dim=2), cos, sin)
        q, k = qk[:, :, :h], qk[:, :, h:]

        if self.decode_max_length > 0:
            if cache is None:
                raise ValueError(
                    "decode mode (decode_max_length > 0) needs a LayerKVCache"
                )
            attn = self._decode_attend(q, k, v, mask, cache, t)
        else:
            attn = self.sdpa(
                q, k, v,
                causal=True,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=self.sinks,
                mask=mask,
            )

        out = attn.reshape(b, t, h * d)
        if self.use_output_gate:
            out = out * torch.sigmoid(self.gate_proj(x))
        return self.o_proj(out)

    def _decode_attend(self, q, k, v, mask, cache: LayerKVCache, t: int):
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
        """
        s_max = self.decode_max_length
        if cache.max_length != s_max:
            raise ValueError(
                f"cache holds {cache.max_length} slots, module was built "
                f"with decode_max_length={s_max}"
            )
        start = cache.index
        _decode_cache_append_heads_major(cache.k, k.to(self.dtype), cache)
        _decode_cache_append_heads_major(cache.v, v.to(self.dtype), cache)
        if t > 1 and not in_continuation_chunk():
            return self.sdpa(
                q, k, v,
                causal=True,
                softmax_scale=self.softmax_scale,
                window_size=self.window_size,
                sinks=self.sinks,
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
                sinks=self.sinks,
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
            sinks=self.sinks,
            mask=_decode_slot_mask(start, t, s_max, self.window_size, mask),
        )
