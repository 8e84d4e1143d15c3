"""Reference ("eager") scaled-dot-product attention in plain PyTorch
(counterpart of ``d9d_tpu/ops/attention/eager.py``).

GQA head broadcasting, causal masking, sliding window, learnable attention
sinks, explicit boolean masks and packed-sequence segment ids in one
fp32-softmax implementation. It is the correctness oracle of the port and
the path for inputs the flash kernels do not take on the CPU (explicit
masks, cross-length attention).

Shape convention is flash-style ``[batch, seq, heads, head_dim]``.
"""

import torch

NEG_INF = float("-inf")


def eager_sdpa(
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
    """Attention over ``q [B,T,Hq,D]``, ``k/v [B,S,Hkv,D]`` → ``[B,T,Hq,Dv]``.

    - GQA: ``Hq`` must be a multiple of ``Hkv``; kv heads are broadcast.
    - ``window_size``: each query attends to keys in ``(pos-window, pos]``.
    - ``sinks [Hq]``: per-head sink logits joining the softmax denominator.
    - ``mask``: boolean, broadcastable to ``[B, Hq, T, S]``; True = attend.
    - ``q_segments [B,T]`` / ``kv_segments [B,S]``: packed-sequence ids;
      attention only within equal ids.

    A fully masked row keeps a finite softmax sentinel: its row maximum is
    replaced by 0, every ``exp(-inf)`` is 0 and the denominator is clamped
    at ``1e-30``, so the row comes out as zeros rather than NaN.
    """
    b, t, hq, d = q.shape
    _, s, hkv, dv = v.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be provided together")

    scale = softmax_scale if softmax_scale is not None else d**-0.5

    qf = q.float().reshape(b, t, hkv, g, d)
    kf = k.float()
    vf = v.float()

    # [B, Hkv, G, T, S]
    logits = torch.einsum("bthgd,bshd->bhgts", qf, kf) * scale

    dev = q.device
    q_pos = torch.arange(t, device=dev)[:, None] + (s - t)  # align last q/k
    k_pos = torch.arange(s, device=dev)[None, :]
    if causal:
        logits = logits.masked_fill(~(k_pos <= q_pos), NEG_INF)
    if window_size is not None:
        logits = logits.masked_fill(~(k_pos > q_pos - window_size), NEG_INF)
    if mask is not None:
        m = torch.broadcast_to(mask, (b, hq, t, s)).reshape(b, hkv, g, t, s)
        logits = logits.masked_fill(~m, NEG_INF)
    if q_segments is not None:
        seg = (
            q_segments[:, None, None, :, None]
            == kv_segments[:, None, None, None, :]
        )
        logits = logits.masked_fill(~seg, NEG_INF)

    if sinks is not None:
        sink = torch.broadcast_to(
            sinks.float().reshape(1, hkv, g, 1, 1), (b, hkv, g, t, 1)
        )
        logits = torch.cat([logits, sink], dim=-1)

    # stable softmax; rows that are fully masked produce zeros, not NaN
    m_max = logits.amax(dim=-1, keepdim=True)
    m_max = torch.where(torch.isfinite(m_max), m_max, torch.zeros_like(m_max))
    unnorm = torch.exp(logits - m_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)

    if sinks is not None:
        probs = probs[..., :-1]

    out = torch.einsum("bhgts,bshd->bthgd", probs, vf)
    return out.reshape(b, t, hq, dv).to(q.dtype)
