"""Flash attention for prefill and training: the CUDA kernels' wrappers,
their plain PyTorch versions, the autograd ``Function`` and the SDPA backend
built on them.

Counterpart of ``d9d_tpu/ops/attention/pallas_flash.py``: the forward
(``_fwd_kernel`` / ``_fwd_call``, the sink fold of ``_flash_fwd``), the
backward (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, ``_bwd_fused_kernel`` /
``_bwd_call``, the delta and dsinks terms of ``_flash_bwd``), the
``custom_vjp`` ``_flash`` and the ``make_pallas_flash_sdpa`` closure; and
the block at global offsets that ring attention is built from
(``flash_attention_block`` with ``_flash_ol``, the kernels'
``has_positions`` mode, and ``combine_attention_chunks``). The kernels
themselves are ``d9d_tpu_torch/csrc/flash_fwd.cu`` (bf16 on the tensor
cores, ``attn_fwd_sm90.cuh``) and ``d9d_tpu_torch/csrc/flash_bwd.cu``
(whose bf16 kernels run on the tensor cores: dq and dk/dv in
``flash_bwd_mma.cuh``, the fused one in ``flash_bwd_fused_mma.cuh``).

Global offsets: ``q_offset`` / ``k_offset`` place the query rows at
positions ``q_offset + [0, T)`` and the keys at ``k_offset + [0, T)`` for
the causal and window masks. They are host ints; the kernels take their
difference by value.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises. The kernel wrappers refuse inputs that
require grad: gradients go through :class:`FlashAttentionFunction`, which
hands the kernels detached tensors.
"""


import operator

import torch

from d9d_tpu_torch.ops.attention.eager import eager_sdpa

NEG_BIG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (32, 64, 128)
# |q_offset - k_offset| the kernels' int arithmetic takes with room to spare
MAX_SHIFT = 2 ** 30


def _check_segments(q_segments, kv_segments):
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be provided together")


def _shift(q_offset, k_offset) -> int:
    """``q_offset - k_offset`` as the int the kernels take by value (an
    offset of ``None`` is 0)."""
    shift = (operator.index(q_offset or 0)
             - operator.index(k_offset or 0))
    if abs(shift) >= MAX_SHIFT:
        raise ValueError(f"q_offset - k_offset = {shift} is out of range "
                         f"(|shift| < {MAX_SHIFT})")
    return shift


def _mask(t, s, dev, causal, window_size, q_segments, kv_segments,
          q_offset=0, k_offset=0):
    """Visibility ``[B or 1, 1, 1, T, S]`` of the kernels: causal, window,
    segment equality, with the rows at ``q_offset + [0, T)`` and the keys at
    ``k_offset + [0, S)``."""
    q_pos = torch.arange(t, device=dev)[:, None] + q_offset
    k_pos = torch.arange(s, device=dev)[None, :] + k_offset
    mask = torch.ones((t, s), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window_size is not None:
        mask = mask & (k_pos > q_pos - window_size)
    mask = mask[None, None, None]
    if q_segments is not None:
        seg = q_segments[:, :, None] == kv_segments[:, None, :]  # [B,T,S]
        mask = mask & seg[:, None, None]
    return mask


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel, explicit fp32 math.

    ``q [B,T,Hq,D]``, ``k/v [B,T,Hkv,D]`` → ``(o [B,T,Hq,D] in q's dtype,
    lse [B,Hq,T] float32)``. Same masks as the kernel (causal, window,
    segment equality), same sentinel arithmetic: masked logits are ``-1e30``,
    probabilities are gated by the mask, the denominator is clamped at
    ``1e-30`` — so a row that sees no key is exact zeros with
    ``lse = -1e30 + log(1e-30)``. No sinks here: see :func:`apply_sinks`.
    ``q_offset`` / ``k_offset``: the rows' and keys' global positions.
    """
    _check_segments(q_segments, kv_segments)
    _shift(q_offset, k_offset)
    b, t, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if s != t:
        raise ValueError(f"flash forward needs equal q/kv lengths, got {t}/{s}")
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d**-0.5

    qf = q.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale

    mask = _mask(t, s, q.device, causal, window_size, q_segments, kv_segments,
                 q_offset, k_offset)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_BIG))

    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = l.clamp_min(1e-30)
    o = torch.einsum("bhgts,bshd->bthgd", p / l_safe, v.float())
    lse = (m + torch.log(l_safe))[..., 0]  # [B,Hkv,g,T]
    return o.reshape(b, t, hq, d).to(q.dtype), lse.reshape(b, hq, t)


def _check_kernel_inputs(name: str, tensors: dict, d: int) -> int:
    """Shared device / dtype / layout checks of the CUDA wrappers; returns
    the dtype code the C launchers take."""
    first = next(iter(tensors.values()))
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{name}: dtype {first.dtype} is not supported by the kernel "
            f"(float32 and bfloat16 are)"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{name}: head_dim {d} is not supported by the kernel "
            f"(supported: {SUPPORTED_HEAD_DIMS})"
        )
    vec = 16 // first.element_size()
    for label, x in tensors.items():
        if x.device != first.device:
            raise ValueError(f"{name}: {label} lies on {x.device}, "
                             f"expected {first.device}")
        if x.dtype != first.dtype:
            raise TypeError(f"{name}: {label} has dtype {x.dtype}, "
                            f"expected {first.dtype}")
        if x.requires_grad:
            raise RuntimeError(
                f"{name}: {label} requires grad — the kernels take detached "
                f"tensors; differentiate through FlashAttentionFunction "
                f"(make_flash_sdpa)"
            )
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {label} needs a contiguous head_dim")
        if any(st % vec for st in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} is not 16-byte aligned in every row "
                f"(strides {x.stride()})"
            )
    return _DTYPE_CODE[first.dtype]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    q_offset: int | None = None,
    k_offset: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward → ``(o [B,T,Hq,D], lse [B,Hq,T] fp32)``.

    CUDA tensors launch ``d9d_flash_fwd`` (``csrc/flash_fwd.cu``) on the
    current stream and raise on anything the kernel does not take; CPU
    tensors take :func:`flash_attention_plain`. The launch counter
    ``flash_attention.launches`` moves only where the kernel is launched.
    Given offsets are the block mode (B4): the same kernel, with the shift
    ``q_offset - k_offset`` passed by value; its launches are also counted
    in ``flash_attention.block_launches``.
    """
    _check_segments(q_segments, kv_segments)
    block = q_offset is not None or k_offset is not None
    shift = _shift(q_offset, k_offset)
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, q_segments=q_segments,
            kv_segments=kv_segments, q_offset=q_offset or 0,
            k_offset=k_offset or 0,
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention: no kernel for device {q.device}; tensors must "
            f"lie on a CUDA device (kernel) or the CPU (plain version)"
        )
    b, t, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: bad k/v shapes {k.shape} {v.shape}")
    if k.shape[1] != t:
        raise ValueError(
            f"flash_attention: needs equal q/kv lengths, got {t}/{k.shape[1]}"
        )
    hkv = k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    code = _check_kernel_inputs("flash_attention", {"q": q, "k": k, "v": v}, d)
    scale = softmax_scale if softmax_scale is not None else d**-0.5

    seg_ptrs = (None, None)
    if q_segments is not None:
        if q_segments.shape != (b, t) or kv_segments.shape != (b, t):
            raise ValueError("flash_attention: segments must be [B, T]")
        # keep the converted tensors alive until the launch is enqueued
        qs = q_segments.to(device=q.device, dtype=torch.int32).contiguous()
        ks = kv_segments.to(device=q.device, dtype=torch.int32).contiguous()
        seg_ptrs = (qs.data_ptr(), ks.data_ptr())

    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)

    from d9d_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.d9d_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), seg_ptrs[0], seg_ptrs[1],
            b, t, hq, hkv, d, code,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)),
            -1 if window_size is None else int(window_size), shift,
            stream,
        )
    kernel_lib.check_launch(code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.block_launches += block
    return o, lse


flash_attention.launches = 0     # kernel launches (CUDA path only)
flash_attention.block_launches = 0  # of which in block mode (offsets given)
flash_attention.plain_calls = 0  # plain-version calls (CPU tensors only)


def apply_sinks(
    o: torch.Tensor, lse: torch.Tensor, sinks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold per-head sink logits ``[Hq]`` into ``(o [B,T,Hq,D], lse
    [B,Hq,T])``. The sink joins only the softmax denominator:
    ``l' = l + exp(sink - m)``, so ``o' = o / (1 + exp(sink - lse))`` and
    ``lse' = lse + log1p(exp(sink - lse))`` — an elementwise step outside
    the kernel, as in the JAX package."""
    z = torch.clamp(sinks.float()[None, :, None] - lse, max=60.0)
    corr = torch.exp(z)  # [B, H, T]
    inv = (1.0 / (1.0 + corr)).transpose(1, 2)[..., None]  # [B,T,H,1]
    o = (o.float() * inv).to(o.dtype)
    return o, lse + torch.log1p(corr)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the three backward kernels, explicit fp32
    math: ``(dq [B,T,Hq,D], dk, dv [B,T,Hkv,D])`` in the inputs' dtypes.

    The TPU kernels' arithmetic over every (query, key) pair: ``s = q.k *
    scale`` masked to ``-1e30``, ``p = exp(s - lse)`` NOT gated by the mask
    (so a row that sees no key, whose lse is the sentinel, gets ``p = 1``
    on every key), ``ds = p * (do.v - delta) * scale``; ``dq = ds.k``,
    ``dk = ds^T.q``, ``dv = p^T.do`` summed over the query heads of each kv
    head. ``lse`` and ``delta`` are ``[B, Hq, T]`` fp32; ``delta`` is
    ``rowsum(do * o)`` (the caller's, as in the JAX package). The split
    kernels and the fused one compute this one function. With global
    offsets the masks move with them; a row that sees no key of the block
    still gets ``p = 1`` on every key here, while the kernels give it that
    only on the key tiles they visit (none for a block wholly in the causal
    future) — ring attention and any caller that combines blocks hand such a
    row a zero cotangent, so neither reaches a gradient (ROADMAP C3).
    """
    _check_segments(q_segments, kv_segments)
    _shift(q_offset, k_offset)
    b, t, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if s != t:
        raise ValueError(f"flash backward needs equal q/kv lengths, got {t}/{s}")
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d**-0.5
    qf = q.float().reshape(b, t, hkv, g, d)
    dof = do.float().reshape(b, t, hkv, g, d)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bthgd,bshd->bhgts", qf, kf) * scale
    mask = _mask(t, s, q.device, causal, window_size, q_segments, kv_segments,
                 q_offset, k_offset)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_BIG))
    p = torch.exp(logits - lse.float().reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bthgd,bshd->bhgts", dof, vf)
    ds = p * (dp - delta.float().reshape(b, hkv, g, t, 1)) * scale
    dq = torch.einsum("bhgts,bshd->bthgd", ds, kf).reshape(b, t, hq, d)
    dk = torch.einsum("bhgts,bthgd->bshd", ds, qf)
    dv = torch.einsum("bhgts,bthgd->bshd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_bwd_applies(
    *, t: int, num_heads: int, num_kv_heads: int, head_dim: int,
    dtype: torch.dtype,
) -> bool:
    """Does ``fused=True`` run the one-pass kernel for CUDA tensors of this
    shape? Counterpart of the JAX package's ``fused_bwd_applies``, but the
    port's fused kernel keeps dq in an fp32 buffer in device memory rather
    than on chip, and orders its adds with a turnstile linear in T, so no
    length limit applies: every shape the split kernels take, the fused
    kernel takes too. A shape neither takes raises; nothing falls back
    silently from one to the other."""
    return (
        t > 0
        and num_kv_heads > 0
        and num_heads % num_kv_heads == 0
        and head_dim in SUPPORTED_HEAD_DIMS
        and dtype in _DTYPE_CODE
    )


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    fused: bool = False,
    q_offset: int | None = None,
    k_offset: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward → ``(dq, dk, dv)`` (see
    :func:`flash_attention_bwd_plain` for the function).

    CUDA tensors launch ``d9d_flash_bwd`` (``csrc/flash_bwd.cu``) on the
    current stream: the dq kernel then the dk/dv kernel (for bf16 on the
    tensor cores, with p and ds rounded to bf16 before the second
    products), or with ``fused=True`` the one-pass kernel (for bf16 on the
    tensor cores too, with p and ds as hi/lo bf16 pairs), which adds dq
    into a zeroed fp32 buffer in ascending key-tile order, so the same
    inputs give the same dq on every run, followed by one cast to the
    inputs' dtype. Anything the kernels do not take raises. CPU
    tensors take the plain version. Launch counters:
    ``flash_attention_bwd.dq_launches`` / ``dkv_launches`` /
    ``fused_launches``; ``plain_calls`` counts the CPU path. Given
    offsets are the block mode (B4), as in :func:`flash_attention`; its
    kernel launches are also counted in ``block_launches``.
    """
    _check_segments(q_segments, kv_segments)
    block = q_offset is not None or k_offset is not None
    shift = _shift(q_offset, k_offset)
    if q.device.type == "cpu":
        flash_attention_bwd.plain_calls += 1
        return flash_attention_bwd_plain(
            q, k, v, do, lse, delta, causal=causal,
            softmax_scale=softmax_scale, window_size=window_size,
            q_segments=q_segments, kv_segments=kv_segments,
            q_offset=q_offset or 0, k_offset=k_offset or 0,
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention_bwd: no kernel for device {q.device}; tensors "
            f"must lie on a CUDA device (kernel) or the CPU (plain version)"
        )
    b, t, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t \
            or k.shape[3] != d or do.shape != q.shape:
        raise ValueError(
            f"flash_attention_bwd: bad shapes q {q.shape} k {k.shape} "
            f"v {v.shape} do {do.shape}"
        )
    hkv = k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    code = _check_kernel_inputs(
        "flash_attention_bwd", {"q": q, "k": k, "v": v, "do": do}, d)
    for label, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, hq, t) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {label} must be a contiguous float32 "
                f"[B, Hq, T] tensor on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
        if x.requires_grad:
            raise RuntimeError(f"flash_attention_bwd: {label} requires grad")
    scale = softmax_scale if softmax_scale is not None else d**-0.5

    qs = ks = None
    if q_segments is not None:
        if q_segments.shape != (b, t) or kv_segments.shape != (b, t):
            raise ValueError("flash_attention_bwd: segments must be [B, T]")
        qs = q_segments.to(device=q.device, dtype=torch.int32).contiguous()
        ks = kv_segments.to(device=q.device, dtype=torch.int32).contiguous()

    dk = torch.empty((b, t, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, d), dtype=v.dtype, device=q.device)
    if fused:
        dq = torch.zeros((b, t, hq, d), dtype=torch.float32, device=q.device)
    else:
        dq = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    args = (q, k, v, do, lse, delta, qs, ks, dq, dk, dv, code, float(scale),
            causal, window_size, shift)
    if fused:
        _launch_bwd(2, *args)
        flash_attention_bwd.fused_launches += 1
        flash_attention_bwd.block_launches += block
        return dq.to(q.dtype), dk, dv
    _launch_bwd(0, *args)
    flash_attention_bwd.dq_launches += 1
    _launch_bwd(1, *args)
    flash_attention_bwd.dkv_launches += 1
    flash_attention_bwd.block_launches += 2 * block
    return dq, dk, dv


def fused_turnstile_len(b: int, hq: int, t: int) -> int:
    """int32 elements of the fused kernel's zeroed turnstile: one counter
    per (batch row, query head, tile of 64 query rows) that orders the dq
    adds, and the ticket that orders the blocks. Linear in T."""
    return b * hq * -(-t // 64) + 1


def _launch_bwd(kernel, q, k, v, do, lse, delta, qs, ks, dq, dk, dv, code,
                scale, causal, window_size, shift=0) -> None:
    """One launch of ``d9d_flash_bwd`` (kernel 0 = dq, 1 = dk/dv, 2 =
    fused, which gets a fresh zeroed turnstile) on checked tensors; raises
    on a launch error. Counts nothing: :func:`flash_attention_bwd` counts
    its own launches."""
    from d9d_tpu_torch.ops import kernel_lib

    b, t, hq, d = q.shape
    turnstile = None
    if kernel == 2:
        turnstile = torch.zeros(fused_turnstile_len(b, hq, t),
                                dtype=torch.int32, device=q.device)
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.d9d_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if qs is None else qs.data_ptr(),
            None if ks is None else ks.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if turnstile is None else turnstile.data_ptr(),
            b, t, hq, k.shape[2], d, code, kernel,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            scale, int(bool(causal)),
            -1 if window_size is None else int(window_size), shift,
            stream,
        )
    kernel_lib.check_launch(err, "flash_attention_bwd")


flash_attention_bwd.dq_launches = 0     # kernel launches (CUDA path only)
flash_attention_bwd.dkv_launches = 0
flash_attention_bwd.fused_launches = 0
flash_attention_bwd.block_launches = 0  # of which in block mode (offsets)
flash_attention_bwd.plain_calls = 0     # plain-version calls (CPU tensors)


def sink_grad(sinks: torch.Tensor, lse: torch.Tensor,
              delta: torch.Tensor) -> torch.Tensor:
    """Analytic sink gradient, outside the kernels as in the JAX package:
    ``p_sink = exp(sink - lse)`` with the sink-corrected lse, ``dsink =
    -sum_{b,t} p_sink * delta`` per head."""
    p_sink = torch.exp(
        torch.clamp(sinks.float()[None, :, None] - lse, max=60.0))
    return -(p_sink * delta).sum(dim=(0, 2)).to(sinks.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (counterpart of the ``custom_vjp``
    ``_flash``): the forward kernel plus the sink fold, saving ``(q, k, v,
    o, lse)`` with the sink-corrected ``lse``; the backward forms ``delta =
    rowsum(do * o)`` and ``dsinks`` in plain PyTorch and runs the backward
    kernels (split, or one-pass with ``fused_bwd``). Segment ids get no
    gradient. The kernels only ever see detached tensors."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, q_segments, kv_segments, causal,
                softmax_scale, window_size, fused_bwd):
        kw = dict(causal=causal, softmax_scale=softmax_scale,
                  window_size=window_size, q_segments=q_segments,
                  kv_segments=kv_segments)
        o, lse = flash_attention(q.detach(), k.detach(), v.detach(), **kw)
        if sinks is not None:
            o, lse = apply_sinks(o, lse, sinks.detach())
        ctx.save_for_backward(q, k, v, o, lse, sinks, q_segments, kv_segments)
        ctx.kw = dict(causal=causal, softmax_scale=softmax_scale,
                      window_size=window_size, fused=fused_bwd)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, sinks, q_seg, kv_seg = ctx.saved_tensors
        do = do.detach().contiguous()
        # delta = rowsum(dO * O) per (b, h, t), O as the forward saved it
        delta = block_delta(do, o, None)
        dq, dk, dv = flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), do, lse, delta,
            q_segments=q_seg, kv_segments=kv_seg, **ctx.kw,
        )
        dsinks = None
        if sinks is not None and ctx.needs_input_grad[3]:
            dsinks = sink_grad(sinks.detach(), lse, delta)
        return dq, dk, dv, dsinks, None, None, None, None, None, None


def block_delta(do: torch.Tensor, o: torch.Tensor,
                dlse: torch.Tensor | None) -> torch.Tensor:
    """The backward kernels' per-row term for a block differentiable in both
    outputs: ``rowsum(do * o) - dlse`` (``_flash_ol_bwd``; ``∂lse/∂s = p``,
    so an lse cotangent folds into the same term), ``[B, Hq, T]`` fp32."""
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float())
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


class FlashBlockFunction(torch.autograd.Function):
    """One flash block at global offsets, differentiable in both ``o`` and
    ``lse`` (counterpart of the ``custom_vjp`` ``_flash_ol``): the forward
    kernel in block mode, saving ``(q, k, v, o, lse)``; the backward forms
    :func:`block_delta` and runs the backward kernels at the same offsets."""

    @staticmethod
    def forward(ctx, q, k, v, q_segments, kv_segments, q_offset, k_offset,
                causal, softmax_scale, window_size, fused_bwd):
        kw = dict(causal=causal, softmax_scale=softmax_scale,
                  window_size=window_size, q_offset=q_offset,
                  k_offset=k_offset)
        o, lse = flash_attention(q.detach(), k.detach(), v.detach(),
                                 q_segments=q_segments,
                                 kv_segments=kv_segments, **kw)
        ctx.save_for_backward(q, k, v, o, lse, q_segments, kv_segments)
        ctx.kw = dict(kw, fused=fused_bwd)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        # o and lse were saved as outputs of the graph: detach for the kernels
        o, lse = o.detach(), lse.detach()
        do = do.detach().to(o.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), do, lse,
            block_delta(do, o, dlse), q_segments=q_seg, kv_segments=kv_seg,
            **ctx.kw,
        )
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int,
    k_offset: int,
    causal: bool = True,
    softmax_scale: float | None = None,
    window_size: int | None = None,
    q_segments: torch.Tensor | None = None,
    kv_segments: torch.Tensor | None = None,
    fused_bwd: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One flash-attention block at global offsets → ``(o, lse)`` (B4).

    ``q [B,T,Hq,D]`` attends ``k/v [B,T,Hkv,D]`` as if the rows sat at
    ``q_offset + [0,T)`` and the keys at ``k_offset + [0,T)``; both outputs
    are differentiable. A row that sees no key of the block comes back as
    ``o = 0, lse ≈ -1e30`` (the JAX block gives the mean of the visited
    ``v`` there, ROADMAP C3); :func:`combine_attention_chunks` weighs it
    to exactly 0. Unlike the JAX block, ``k``/``v`` must have the query
    chunk's length (ring chunks do): ``T != S`` raises.
    """
    _check_segments(q_segments, kv_segments)
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"flash_attention_block: the kernels take equal q/kv block "
            f"lengths, got {q.shape[1]}/{k.shape[1]}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return FlashBlockFunction.apply(
            q, k, v, q_segments, kv_segments, q_offset, k_offset, causal,
            softmax_scale, window_size, fused_bwd)
    # no gradient wanted (or grad mode off): the kernel on detached inputs
    return flash_attention(
        q.detach(), k.detach(), v.detach(), causal=causal,
        softmax_scale=softmax_scale, window_size=window_size,
        q_segments=q_segments, kv_segments=kv_segments, q_offset=q_offset,
        k_offset=k_offset)


def combine_attention_chunks(
    o: torch.Tensor, lse: torch.Tensor, o_new: torch.Tensor,
    lse_new: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two normalized partial results ``(o [B,T,H,D], lse [B,H,T])``
    over disjoint key sets: ``lse = logaddexp(lse, lse_new)``, ``o = exp(lse
    - merged)·o + exp(lse_new - merged)·o_new`` in fp32 (the JAX function of
    the same name). Plain differentiable PyTorch."""
    merged = torch.logaddexp(lse, lse_new)
    w0 = torch.exp(lse - merged).transpose(1, 2)[..., None]
    w1 = torch.exp(lse_new - merged).transpose(1, 2)[..., None]
    return o.float() * w0 + o_new.float() * w1, merged


def make_flash_sdpa(fused_bwd: bool = False):
    """Build an SDPA backend on the flash kernels.

    Mirrors ``make_pallas_flash_sdpa``: an explicit ``mask`` or a
    cross-length call (``Tq != Tk``) has no kernel. On CPU tensors it goes to
    :func:`eager_sdpa`, counted in ``sdpa.eager_calls``; on any other device
    it raises ``NotImplementedError``. Everything else goes to the flash
    kernels: through :class:`FlashAttentionFunction` when a gradient is
    wanted, straight to :func:`flash_attention` plus the sink fold when not
    (serving). ``fused_bwd`` selects the one-pass backward kernel; it is an
    argument only, never read from the environment.
    """

    def sdpa(
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
        if mask is not None or q.shape[1] != k.shape[1]:
            if q.device.type != "cpu":
                raise NotImplementedError(
                    "flash sdpa: an explicit mask or unequal q/kv lengths "
                    f"({q.shape[1]}/{k.shape[1]}) has no kernel; only CPU "
                    "tensors take the eager path"
                )
            sdpa.eager_calls += 1
            return eager_sdpa(
                q, k, v, causal=causal, softmax_scale=softmax_scale,
                window_size=window_size, sinks=sinks, mask=mask,
                q_segments=q_segments, kv_segments=kv_segments,
            )
        _check_segments(q_segments, kv_segments)
        if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, sinks)
        ):
            return FlashAttentionFunction.apply(
                q, k, v, sinks, q_segments, kv_segments, causal,
                softmax_scale, window_size, fused_bwd,
            )
        o, lse = flash_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, q_segments=q_segments,
            kv_segments=kv_segments,
        )
        if sinks is not None:
            o, _ = apply_sinks(o, lse, sinks)
        return o

    sdpa.eager_calls = 0
    return sdpa


__all__ = [
    "FlashAttentionFunction",
    "FlashBlockFunction",
    "combine_attention_chunks",
    "flash_attention_block",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "fused_bwd_applies",
    "sink_grad",
    "apply_sinks",
    "make_flash_sdpa",
    "SUPPORTED_HEAD_DIMS",
]
