"""Flash-decode attention over a heads-major KV slot cache or over page
pools: the CUDA kernels' wrappers and their plain PyTorch versions.

Counterpart of ``d9d_tpu/ops/attention/pallas_decode.py``: the contiguous
mode (``_decode_kernel`` / ``_decode_call``) and the paged mode with its
int8 pools (``_paged_decode_kernel`` / ``_paged_decode_call``), both behind
``flash_decode_attention``. The kernels are ``d9d_flash_decode`` and
``d9d_flash_paged_decode`` of ``d9d_tpu_torch/csrc/flash_decode.cu``.

Dispatch: a tensor on the CPU takes the plain version
(:func:`flash_decode_plain`, :func:`flash_decode_paged_plain`); a CUDA tensor
launches the kernel or raises.

Routes on the card (``csrc/flash_decode.cu``): every bf16 call with at most
16 query rows per kv head (``g·T``; every serving step) and every bf16
paged call take the cluster core (``csrc/attn_decode_sm90.cuh``): exactly
one launch per call, the caller's ``start`` (0-dim or ``[B]`` int32) and
``kv_valid`` (bool or int32, with its row stride) read as they come,
no split scratch (:func:`decode_cluster` sizes the clusters). fp32 calls and
bf16 continuation chunks keep the grid.z key split of :func:`decode_split`
(a second launch merges the splits) and take ``start`` as ``[B]`` int32 and
``kv_valid`` as int32.
"""

import ctypes
import functools

import torch

from d9d_tpu_torch.ops.attention.flash import NEG_BIG, _check_kernel_inputs

# aim for this many blocks before splitting the key range stops paying,
# and never split below this many keys
_TARGET_BLOCKS = 1024
_MIN_SPLIT_KEYS = 128
# key-validity types the cluster core reads as they come, and their widths
_VALID_BYTES = {torch.bool: 1, torch.int32: 4}
# head dims the decode cores of csrc/flash_decode.cu are built for (the
# flash kernels' SUPPORTED_HEAD_DIMS also has 32, which these lack)
DECODE_HEAD_DIMS = (64, 128)


def _check_decode_head_dim(name: str, d: int) -> None:
    """Raise ``ValueError`` for a head_dim the decode cores lack, before
    any CUDA call."""
    if d not in DECODE_HEAD_DIMS:
        raise ValueError(
            f"{name}: head_dim {d} is not supported by the decode kernels "
            f"(supported: {DECODE_HEAD_DIMS})")


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


def decode_cluster(b: int, hkv: int, rows: int, capacity: dict,
                   row_tile: int = 16) -> int:
    """Blocks per cluster (1, 2, 4 or 8) of the cluster core, from shapes
    only (the write indices live on the device and are never read back):
    the largest n whose ``b · hkv · ⌈rows / row_tile⌉`` clusters the card
    holds at once (``capacity[n]``, from the library), since a second wave
    pays the first tile's trip and the merge again. Each block takes its
    share of its row's visible keys."""
    clusters = b * hkv * -(-rows // row_tile)
    for n in (8, 4, 2):
        if clusters <= capacity[n]:
            return n
    return 1


@functools.lru_cache(maxsize=None)
def cluster_capacity(device: torch.device, paged: bool, kv_int8: bool,
                     d: int) -> dict:
    """``{n: clusters of n blocks the card holds at once}`` for the cluster
    core of this mode (``d9d_flash_decode_max_clusters``), once per device."""
    from d9d_tpu_torch.ops import kernel_lib

    out = {}
    with torch.cuda.device(device):
        for n in (1, 2, 4, 8):
            held = ctypes.c_int()
            kernel_lib.check_launch(
                kernel_lib.load().d9d_flash_decode_max_clusters(
                    int(paged), int(kv_int8), d, n, ctypes.byref(held)),
                "flash_decode cluster capacity query",
            )
            out[n] = held.value
    return out


@functools.lru_cache(maxsize=None)
def _tiling(code: int, rows: int, paged: bool) -> tuple[int, int]:
    """``(query rows per block, split_len granularity)`` the library
    reports for a call (``d9d_flash_decode_tiling``), once per dtype, row
    count and mode; a granularity of 0 is the cluster core."""
    from d9d_tpu_torch.ops import kernel_lib

    row_tile, align = ctypes.c_int(), ctypes.c_int()
    kernel_lib.check_launch(
        kernel_lib.load().d9d_flash_decode_tiling(
            code, rows, int(paged), ctypes.byref(row_tile),
            ctypes.byref(align)),
        "flash_decode tiling query",
    )
    return row_tile.value, align.value


def _start_view(start, b: int, device) -> tuple[torch.Tensor, int]:
    """The write index as the cluster core reads it: ``(int32 tensor,
    element stride)`` — a 0-dim or ``[B]`` int32 tensor on ``device`` as it
    is (stride 0 for one shared index), anything else converted once."""
    if not (isinstance(start, torch.Tensor) and start.dtype == torch.int32
            and start.device == device):
        start = torch.as_tensor(start, device=device).to(torch.int32)
    if start.ndim == 0:
        return start, 0
    if start.numel() == 1:
        return start.reshape(()), 0
    if start.shape != (b,):
        raise ValueError(
            f"flash_decode: start must be a scalar or [B]={b}, got "
            f"{tuple(start.shape)}")
    return start, start.stride(0)


def _valid_view(kv_valid: torch.Tensor, b: int, s: int,
                device) -> tuple[torch.Tensor, int, int]:
    """``kv_valid [B, S]`` as the cluster core reads it: ``(tensor, bytes
    per flag, row stride)`` — bool or int32 with contiguous keys as it
    comes (the ``[B, 1, 1, S]`` mask's ``[:, 0, 0, :]`` view), other
    types as a bool copy. The kernel copies flags 4 bytes at a time,
    so one-byte flags whose rows do not start 4-byte aligned go as int32."""
    if kv_valid.shape != (b, s):
        raise ValueError(
            f"flash_decode: kv_valid must be [B,S]={b, s}, "
            f"got {tuple(kv_valid.shape)}"
        )
    kv = kv_valid.to(device)
    if kv.dtype not in _VALID_BYTES:
        kv = kv != 0
    if kv.stride(-1) != 1:
        kv = kv.contiguous()
    if _VALID_BYTES[kv.dtype] == 1 and (kv.data_ptr() % 4 or kv.stride(0) % 4):
        kv = kv.to(torch.int32)
    return kv, _VALID_BYTES[kv.dtype], kv.stride(0)


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
    _check_decode_head_dim("flash_decode", d)
    code = _check_kernel_inputs(
        "flash_decode", {"q": q, "k_cache": k_cache, "v_cache": v_cache}, d
    )
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    rows = (hq // hkv) * t
    row_tile, align = _tiling(code, rows, False)
    valid_ptr, valid_bytes, valid_sb = None, 0, 0
    o_part = lse_part = None
    if align == 0:  # the cluster core: one launch, inputs as they come
        offsets, offsets_stride = _start_view(start, b, q.device)
        if kv_valid is not None:
            valid, valid_bytes, valid_sb = _valid_view(kv_valid, b, s,
                                                       q.device)
            valid_ptr = valid.data_ptr()
        n_splits, split_len = decode_cluster(
            b, hkv, rows, cluster_capacity(q.device, False, False, d),
            row_tile), 0
    else:
        offsets, offsets_stride = _broadcast_start(start, b, q.device), 1
        if kv_valid is not None:
            valid = (_valid_view(kv_valid, b, s, q.device)[0] != 0).to(
                torch.int32).contiguous()
            valid_ptr, valid_bytes, valid_sb = valid.data_ptr(), 4, s
        n_splits, split_len = decode_split(b, hkv, rows, s, row_tile, align)
        if n_splits > 1:
            o_part = torch.empty(
                (b * hkv, n_splits, rows, d), dtype=torch.float32,
                device=q.device)
            lse_part = torch.empty(
                (b * hkv, n_splits, rows), dtype=torch.float32,
                device=q.device)
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)

    from d9d_tpu_torch.ops import kernel_lib

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernel_lib.load().d9d_flash_decode(
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
            n_splits, split_len, offsets_stride, valid_bytes, valid_sb,
            stream,
        )
    kernel_lib.check_launch(code, "flash_decode")
    flash_decode.launches += 1
    return o, lse


flash_decode.launches = 0     # kernel launches (CUDA path only)
flash_decode.plain_calls = 0  # plain-version calls (CPU tensors only)


def gather_pages_heads_major(
    pool: torch.Tensor, page_table: torch.Tensor
) -> torch.Tensor:
    """Contiguous per-row view of a heads-major page pool: ``[P, H, ps, D]``
    gathered through ``[B, n]`` → ``[B, H, n·ps, D]``, slot order kept (the
    counterpart of ``_gather_pages_heads_major`` in
    ``d9d_tpu/nn/attention.py``, the JAX package's eager paged oracle)."""
    g = pool[page_table.long()]  # [B, n, H, ps, D]
    b, n, h, ps, d = g.shape
    return g.transpose(1, 2).reshape(b, h, n * ps, d)


def gather_pages_heads_major_quant(
    pool: torch.Tensor, scale_pool: torch.Tensor, page_table: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Quantized sibling of :func:`gather_pages_heads_major`: gather the int8
    pool and its ``[P, H, ps]`` scale pool through the same table, widen
    ``int8 * scale`` per slot in fp32, return the dense view in ``dtype``."""
    pt = page_table.long()
    g = pool[pt].float() * scale_pool[pt][..., None]  # [B, n, H, ps, D]
    b, n, h, ps, d = g.shape
    return g.to(dtype).transpose(1, 2).reshape(b, h, n * ps, d)


def flash_decode_paged_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    *,
    start: torch.Tensor,
    page_table: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    softmax_scale: float | None = None,
    window_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the paged flash-decode kernel: the visible
    cache gathered from the pools ``[P, Hkv, ps, D]`` through
    ``page_table [B, n_pages]`` (int8 pools dequantized by their
    ``[P, Hkv, ps]`` scales in fp32), then :func:`flash_decode_plain`'s
    mask, fp32 softmax and product — the reference kernel's order. Every
    slot of the ``n_pages·ps`` gathered ones is addressable."""
    if k_scale is not None:
        kc = gather_pages_heads_major_quant(
            k_pool, k_scale, page_table, torch.float32)
        vc = gather_pages_heads_major_quant(
            v_pool, v_scale, page_table, torch.float32)
    else:
        kc = gather_pages_heads_major(k_pool, page_table)
        vc = gather_pages_heads_major(v_pool, page_table)
    return flash_decode_plain(
        q, kc, vc, start=start, softmax_scale=softmax_scale,
        window_size=window_size,
    )


def _check_paged_inputs(q, k_pool, v_pool, page_table, k_scale, v_scale):
    """The paged kernel's shape / dtype / layout contract; returns
    ``(dtype code, kv_int8)``."""
    b, _, hq, d = q.shape
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError(
            f"flash_decode_paged: pools must be [P,Hkv,page_size,D], got "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
        )
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"flash_decode_paged: page_table must be [B, n_pages] with B={b}, "
            f"got {tuple(page_table.shape)}"
        )
    if hq % k_pool.shape[1] != 0:
        raise ValueError(
            f"query heads {hq} not a multiple of kv heads {k_pool.shape[1]}")
    _check_decode_head_dim("flash_decode_paged", d)
    if k_scale is None:
        code = _check_kernel_inputs(
            "flash_decode_paged", {"q": q, "k_pool": k_pool, "v_pool": v_pool},
            d)
        return code, 0
    code = _check_kernel_inputs("flash_decode_paged", {"q": q}, d)
    for label, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if pool.dtype != torch.int8 or not pool.is_contiguous() \
                or pool.device != q.device:
            raise TypeError(
                f"flash_decode_paged: with scales, {label} must be a "
                f"contiguous int8 pool on {q.device}, got {pool.dtype} on "
                f"{pool.device}"
            )
    for label, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.dtype != torch.float32 or sc.shape != k_pool.shape[:3] \
                or not sc.is_contiguous() or sc.device != q.device:
            raise TypeError(
                f"flash_decode_paged: {label} must be a contiguous float32 "
                f"[P,Hkv,page_size] = {tuple(k_pool.shape[:3])} on {q.device}"
            )
    return code, 1


def flash_decode_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    *,
    start: torch.Tensor,
    page_table: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    softmax_scale: float | None = None,
    window_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Paged flash-decode attention → ``(o [B,T,Hq,D], lse [B,Hq,T] fp32)``.

    CUDA tensors launch ``d9d_flash_paged_decode`` (``csrc/flash_decode.cu``)
    on the current stream and raise on anything the kernel does not take;
    CPU tensors take :func:`flash_decode_paged_plain`.
    ``flash_decode_paged.launches`` moves only where the kernel is launched.
    The page ids are not read back: every entry must name a page of the
    pools (the serving loop's idle rows name the garbage page 0).
    """
    if q.device.type == "cpu":
        flash_decode_paged.plain_calls += 1
        return flash_decode_paged_plain(
            q, k_pool, v_pool, start=start, page_table=page_table,
            k_scale=k_scale, v_scale=v_scale, softmax_scale=softmax_scale,
            window_size=window_size,
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_decode_paged: no kernel for device {q.device}; tensors "
            f"must lie on a CUDA device (kernel) or the CPU (plain version)"
        )
    code, kv_int8 = _check_paged_inputs(
        q, k_pool, v_pool, page_table, k_scale, v_scale)
    b, t, hq, d = q.shape
    hkv, ps = k_pool.shape[1], k_pool.shape[2]
    n_pages = page_table.shape[1]
    s = n_pages * ps
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    rows = (hq // hkv) * t
    row_tile, align = _tiling(code, rows, True)
    o_part = lse_part = None
    if align == 0:  # the cluster core: one launch, inputs as they come
        offsets, offsets_stride = _start_view(start, b, q.device)
        n_splits, split_len = decode_cluster(
            b, hkv, rows, cluster_capacity(q.device, True, bool(kv_int8), d),
            row_tile), 0
    else:
        offsets, offsets_stride = _broadcast_start(start, b, q.device), 1
        n_splits, split_len = decode_split(b, hkv, rows, s, row_tile, align)
        if n_splits > 1:
            o_part = torch.empty(
                (b * hkv, n_splits, rows, d), dtype=torch.float32,
                device=q.device)
            lse_part = torch.empty(
                (b * hkv, n_splits, rows), dtype=torch.float32,
                device=q.device)
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)

    from d9d_tpu_torch.ops import kernel_lib

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernel_lib.load().d9d_flash_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            o.data_ptr(), lse.data_ptr(), offsets.data_ptr(), table.data_ptr(),
            None if o_part is None else o_part.data_ptr(),
            None if lse_part is None else lse_part.data_ptr(),
            b, t, hq, hkv, ps, n_pages, d, code, kv_int8,
            q.stride(0), q.stride(1), q.stride(2),
            k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
            v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), -1 if window_size is None else int(window_size),
            n_splits, split_len, offsets_stride, stream,
        )
    kernel_lib.check_launch(code, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return o, lse


flash_decode_paged.launches = 0     # kernel launches (CUDA path only)
flash_decode_paged.plain_calls = 0  # plain-version calls (CPU tensors only)


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

    PAGED mode (``page_table [B, n_pages]`` set): ``k/v`` are page pools
    ``[P, Hkv, page_size, D]`` and row ``b``'s logical key block ``ki`` is
    pool page ``page_table[b, ki]``; every one of the ``n_pages·page_size``
    gathered slots is addressable. ``kv_valid`` does not compose with paging
    (the serving loop's paged rows are never left-padded). QUANTIZED paged
    mode (``k_scale`` / ``v_scale [P, Hkv, page_size]`` set): int8 pools,
    each slot dequantized by its f32 scale inside the fp32 accumulation.
    """
    if page_table is not None:
        if kv_valid is not None:
            raise NotImplementedError(
                "paged decode does not take kv_valid (the serving loop's "
                "paged rows are never left-padded)"
            )
        if (k_scale is None) != (v_scale is None):
            raise ValueError("k_scale and v_scale must be set together")
        o, lse = flash_decode_paged(
            q, k_cache, v_cache, start=start, page_table=page_table,
            k_scale=k_scale, v_scale=v_scale, softmax_scale=softmax_scale,
            window_size=window_size,
        )
    elif k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "k_scale/v_scale are paged-mode arguments (quantized pools need "
            "a page_table)"
        )
    else:
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
    itemsize: int, window_size: int | None = None, *,
    page_size: int | None = None, n_pages: int = 0,
    kv_itemsize: int | None = None, quant: bool = False,
) -> float:
    """Bytes one call must move for these write indices: the visible cache
    slots of every (row, kv head) read once for k and once for v, q read
    and o written once. Reads ``start`` back to the host — for measurement
    scripts, never for the serving path.

    Paged (``page_size`` set): the cache is read in whole pages, so every
    page holding a visible slot counts, at ``kv_itemsize`` bytes an element
    (int8: 1), with its f32 scales when ``quant``; the ``[B, n_pages]``
    int32 page table is read once."""
    offs = torch.as_tensor(start).reshape(-1).to(torch.int64).cpu()
    if offs.numel() == 1:
        offs = offs.expand(b)
    seen = offs + t
    if window_size is not None:
        seen = torch.minimum(seen, torch.full_like(seen, window_size + t - 1))
    qo = 2.0 * b * t * hq * d * itemsize
    if page_size is None:
        return float(seen.sum()) * hkv * d * 2 * itemsize + qo
    last = offs + t - 1  # each row's last visible slot
    first = last - seen + 1
    pages = float((last // page_size - first // page_size + 1).sum())
    slot_bytes = d * (itemsize if kv_itemsize is None else kv_itemsize)
    if quant:
        slot_bytes += 4
    cache = pages * page_size * hkv * 2 * slot_bytes
    return cache + qo + 4.0 * b * n_pages


__all__ = [
    "DECODE_HEAD_DIMS",
    "flash_decode",
    "flash_decode_plain",
    "flash_decode_paged",
    "flash_decode_paged_plain",
    "gather_pages_heads_major",
    "gather_pages_heads_major_quant",
    "flash_decode_attention",
    "decode_split",
    "decode_cluster",
    "cluster_capacity",
    "flash_decode_bytes",
]
