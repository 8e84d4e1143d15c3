"""Flash-attention forward for prefill: the CUDA kernel's wrapper, its plain
PyTorch version, and the SDPA backend built on them.

Counterpart of ``d9d_tpu/ops/attention/pallas_flash.py`` (forward only:
``_fwd_kernel`` / ``_fwd_call``, the sink fold of ``_flash_fwd`` and the
``make_pallas_flash_sdpa`` closure). The kernel itself is
``d9d_tpu_torch/csrc/flash_fwd.cu``.

Dispatch: a tensor on the CPU takes :func:`flash_attention_plain`; a CUDA
tensor launches the kernel or raises. No backward: inputs that require grad
are refused.
"""


import torch

from d9d_tpu_torch.ops.attention.eager import eager_sdpa

NEG_BIG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (64, 128)


def _check_segments(q_segments, kv_segments):
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be provided together")


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel, explicit fp32 math.

    ``q [B,T,Hq,D]``, ``k/v [B,T,Hkv,D]`` → ``(o [B,T,Hq,D] in q's dtype,
    lse [B,Hq,T] float32)``. Same masks as the kernel (causal, window,
    segment equality), same sentinel arithmetic: masked logits are ``-1e30``,
    probabilities are gated by the mask, the denominator is clamped at
    ``1e-30`` — so a row that sees no key is exact zeros with
    ``lse = -1e30 + log(1e-30)``. No sinks here: see :func:`apply_sinks`.
    """
    _check_segments(q_segments, kv_segments)
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

    dev = q.device
    q_pos = torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(s, device=dev)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window_size is not None:
        mask = mask & (k_pos > q_pos - window_size)
    mask = mask[None, None, None]  # [1,1,1,T,S]
    if q_segments is not None:
        seg = q_segments[:, :, None] == kv_segments[:, None, :]  # [B,T,S]
        mask = mask & seg[:, None, None]
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
                f"{name}: {label} requires grad — the kernel is forward-only"
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward → ``(o [B,T,Hq,D], lse [B,Hq,T] fp32)``.

    CUDA tensors launch ``d9d_flash_fwd`` (``csrc/flash_fwd.cu``) on the
    current stream and raise on anything the kernel does not take; CPU
    tensors take :func:`flash_attention_plain`. The launch counter
    ``flash_attention.launches`` moves only where the kernel is launched.
    """
    _check_segments(q_segments, kv_segments)
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, q_segments=q_segments,
            kv_segments=kv_segments,
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
            -1 if window_size is None else int(window_size),
            stream,
        )
    kernel_lib.check_launch(code, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0     # kernel launches (CUDA path only)
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


def make_flash_sdpa():
    """Build an SDPA backend on the flash forward kernel.

    Mirrors ``make_pallas_flash_sdpa``: an explicit ``mask`` or a
    cross-length call (``Tq != Tk``) has no kernel. On CPU tensors it goes to
    :func:`eager_sdpa`, counted in ``sdpa.eager_calls``; on any other device
    it raises ``NotImplementedError``. Everything else goes to
    :func:`flash_attention` plus the sink fold.
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
    "flash_attention",
    "flash_attention_plain",
    "apply_sinks",
    "make_flash_sdpa",
    "SUPPORTED_HEAD_DIMS",
]
