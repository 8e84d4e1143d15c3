"""Flash-decode attention over a heads-major KV slot cache: the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``d9d_tpu/ops/attention/pallas_decode.py`` in its contiguous
mode (``_decode_kernel`` / ``_decode_call`` / ``flash_decode_attention``).
The kernel itself is ``d9d_tpu_torch/csrc/flash_decode.cu``.

Dispatch: a tensor on the CPU takes :func:`flash_decode_plain`; a CUDA tensor
launches the kernel or raises. The paged (``page_table``) and quantized
(``k_scale`` / ``v_scale``) modes of the JAX function are not ported yet and
raise ``NotImplementedError``.
"""

import ctypes

import torch

from d9d_tpu_torch.ops.attention.flash import NEG_BIG, _check_kernel_inputs

# aim for this many blocks before splitting the key range stops paying,
# and never split below this many keys
_TARGET_BLOCKS = 1024
_MIN_SPLIT_KEYS = 128


def _broadcast_start(start, b: int, device) -> torch.Tensor:
    start = torch.as_tensor(start, device=device).to(torch.int32)
    return torch.broadcast_to(start.reshape(-1), (b,)).contiguous()


def flash_decode_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    start: torch.Tensor,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    kv_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash-decode kernel, explicit fp32 math.

    ``q [B,T,Hq,D]`` (new tokens at cache positions ``start + [0,T)``)
    against the heads-major slot cache ``k/v [B,Hkv,S,D]`` →
    ``(o [B,T,Hq,D] in q's dtype, lse [B,Hq,T] float32)``. ``start`` is a
    scalar or per-row ``[B]``; ``kv_valid [B,S]`` masks dead slots. Masked
    logits are ``-1e30``, probabilities are gated by the mask and the
    denominator is clamped at ``1e-30``: a row with no visible key yields
    exact zeros and ``lse = -1e30 + log(1e-30)``.
    """
    b, t, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    dev = q.device
    offsets = _broadcast_start(start, b, dev)

    qf = q.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum("bthgd,bhsd->bhgts", qf, k_cache.float()) * scale

    q_pos = offsets[:, None, None] + torch.arange(t, device=dev)[None, :, None]
    k_pos = torch.arange(s, device=dev)[None, None, :]
    mask = k_pos <= q_pos  # [B,T,S]
    if window_size is not None:
        mask = mask & (k_pos > q_pos - window_size)
    if kv_valid is not None:
        mask = mask & (kv_valid != 0)[:, None, :]
    mask = mask[:, None, None]  # [B,1,1,T,S]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_BIG))

    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = l.clamp_min(1e-30)
    o = torch.einsum("bhgts,bhsd->bthgd", p / l_safe, v_cache.float())
    lse = (m + torch.log(l_safe))[..., 0]  # [B,Hkv,g,T]
    return o.reshape(b, t, hq, d).to(q.dtype), lse.reshape(b, hq, t)


def decode_split(
    b: int, hkv: int, rows: int, s: int, row_tile: int = 16, align: int = 64
) -> tuple[int, int]:
    """``(n_splits, split_len)`` of the key range, from shapes only (the
    write indices live on the device and are never read back): split until
    about ``_TARGET_BLOCKS`` blocks exist, never below ``_MIN_SPLIT_KEYS``
    keys a split. ``row_tile`` (query rows a block holds) and ``align``
    (granularity of ``split_len``) are the kernel's own: the wrapper asks
    the library for them (``d9d_flash_decode_tiling``)."""
    base = b * hkv * -(-rows // row_tile)
    n = 1 if base >= _TARGET_BLOCKS // 2 else min(
        -(-s // _MIN_SPLIT_KEYS), -(-_TARGET_BLOCKS // base)
    )
    split_len = -(-s // n)
    split_len = -(-split_len // align) * align
    return -(-s // split_len), split_len


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    start: torch.Tensor,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    kv_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-decode attention → ``(o [B,T,Hq,D], lse [B,Hq,T] fp32)``.

    CUDA tensors launch ``d9d_flash_decode`` (``csrc/flash_decode.cu``) on
    the current stream — any number of query rows ``g·T`` rides the kernel —
    and raise on anything the kernel does not take; CPU tensors take
    :func:`flash_decode_plain`. ``flash_decode.launches`` moves only where
    the kernel is launched.
    """
    if q.device.type == "cpu":
        flash_decode.plain_calls += 1
        return flash_decode_plain(
            q, k_cache, v_cache, start=start, softmax_scale=softmax_scale,
            window_size=window_size, kv_valid=kv_valid,
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_decode: no kernel for device {q.device}; tensors must "
            f"lie on a CUDA device (kernel) or the CPU (plain version)"
        )
    b, t, hq, d = q.shape
    if (
        k_cache.ndim != 4 or k_cache.shape != v_cache.shape
        or k_cache.shape[0] != b or k_cache.shape[3] != d
    ):
        raise ValueError(
            f"flash_decode: cache must be [B,Hkv,S,D], got {k_cache.shape} "
            f"/ {v_cache.shape}"
        )
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    code = _check_kernel_inputs(
        "flash_decode", {"q": q, "k_cache": k_cache, "v_cache": v_cache}, d
    )
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    offsets = _broadcast_start(start, b, q.device)

    valid_ptr = None
    if kv_valid is not None:
        if kv_valid.shape != (b, s):
            raise ValueError(
                f"flash_decode: kv_valid must be [B,S]={b, s}, "
                f"got {tuple(kv_valid.shape)}"
            )
        valid = (kv_valid.to(q.device) != 0).to(torch.int32).contiguous()
        valid_ptr = valid.data_ptr()

    from d9d_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    rows = (hq // hkv) * t
    row_tile, align = ctypes.c_int(), ctypes.c_int()
    kernel_lib.check_launch(
        lib.d9d_flash_decode_tiling(
            code, rows, ctypes.byref(row_tile), ctypes.byref(align)
        ),
        "flash_decode tiling query",
    )
    n_splits, split_len = decode_split(
        b, hkv, rows, s, row_tile.value, align.value
    )
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    o_part = lse_part = None
    if n_splits > 1:
        o_part = torch.empty(
            (b * hkv, n_splits, rows, d), dtype=torch.float32, device=q.device
        )
        lse_part = torch.empty(
            (b * hkv, n_splits, rows), dtype=torch.float32, device=q.device
        )

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.d9d_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            o.data_ptr(), lse.data_ptr(), offsets.data_ptr(), valid_ptr,
            None if o_part is None else o_part.data_ptr(),
            None if lse_part is None else lse_part.data_ptr(),
            b, t, hq, hkv, s, d, code,
            q.stride(0), q.stride(1), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), -1 if window_size is None else int(window_size),
            n_splits, split_len, stream,
        )
    kernel_lib.check_launch(code, "flash_decode")
    flash_decode.launches += 1
    return o, lse


flash_decode.launches = 0     # kernel launches (CUDA path only)
flash_decode.plain_calls = 0  # plain-version calls (CPU tensors only)


def flash_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    start: torch.Tensor,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    sinks: torch.Tensor | None = None,
    kv_valid: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode-step attention: ``q [B,T,Hq,D]`` (new tokens at cache positions
    ``start + [0,T)``) against the full slot cache ``k/v [B,Hkv,S,D]``
    (heads-major, streamed with no relayout) → ``[B,T,Hq,D]``.

    Slot-causal plus optional sliding window over global positions; ``start``
    is a scalar (one shared write index — the closed-batch generate loop) or
    per-row ``[B]`` (continuous batching). ``kv_valid [B,S]`` masks dead
    slots (left-padded ragged prompts); ``sinks [Hq]`` join the softmax
    denominator through the outside-the-kernel correction. A query row whose
    every key is masked yields exact zeros. Forward-only.

    ``page_table`` (paged pools) and ``k_scale`` / ``v_scale`` (int8 pools)
    are not ported yet and raise ``NotImplementedError``.
    """
    if page_table is not None:
        raise NotImplementedError(
            "paged flash-decode (page_table) is not ported yet"
        )
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized flash-decode (k_scale / v_scale) is not ported yet"
        )
    o, lse = flash_decode(
        q, k_cache, v_cache, start=start, softmax_scale=softmax_scale,
        window_size=window_size, kv_valid=kv_valid,
    )
    if sinks is not None:
        # sink joins only the denominator: o' = o / (1 + exp(sink - lse))
        z = torch.clamp(sinks.float()[None, :, None] - lse, max=60.0)
        inv = (1.0 / (1.0 + torch.exp(z))).transpose(1, 2)[..., None]
        o = (o.float() * inv).to(o.dtype)
    return o


def flash_decode_bytes(
    start: torch.Tensor, t: int, b: int, hq: int, hkv: int, d: int,
    itemsize: int, window_size: int | None = None,
) -> float:
    """Bytes one call must move for these write indices: the visible cache
    slots of every (row, kv head) read once for k and once for v, q read
    and o written once. Reads ``start`` back to the host — for measurement
    scripts, never for the serving path."""
    offs = torch.as_tensor(start).reshape(-1).to(torch.int64).cpu()
    if offs.numel() == 1:
        offs = offs.expand(b)
    seen = offs + t
    if window_size is not None:
        seen = torch.minimum(seen, torch.full_like(seen, window_size + t - 1))
    cache = float(seen.sum()) * hkv * d * 2 * itemsize
    qo = 2.0 * b * t * hq * d * itemsize
    return cache + qo


__all__ = [
    "flash_decode",
    "flash_decode_plain",
    "flash_decode_attention",
    "decode_split",
    "flash_decode_bytes",
]
