#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``d9d_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. Phases:

1. device — fail at once without a CUDA device; print the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build — compile the port's CUDA kernels from ``d9d_tpu_torch/csrc``;
3. kernels — hold each kernel against its plain PyTorch version on the card
   (bf16 and fp32, at the main paths' shapes), time kernel, plain version
   and one library call that computes the same function (a yardstick only —
   the port never calls it), and compute the card's least time for the work:
   the flash forward and decode kernels, and the three flash backward kernels
   (dq, dk/dv, fused), the latter with negative controls for their bf16 rule;
4. small end-to-end agreement — serving: a narrow fp32 model on the card
   (through the kernels) against the same weights on the CPU (through the
   plain versions): greedy tokens identical, logits within tolerance; the
   batcher against ``generate`` on the card. Training: 3 ``Trainer`` steps
   of a narrow fp32 model on the card against 3 on the CPU, loss and grad
   norm per step within tolerance, and a step with the fused backward
   against the split one;
5. full width, serving — Qwen3-8B (36 layers, random seeded bf16 weights):
   ``generate`` on a ragged batch with chunked prefill, then a
   ``ContinuousBatcher`` that drains 12 requests;
6. full width, training — Qwen3-8B widths at 8 of its 36 layers (fp32
   parameters, bf16 compute, full remat, AdamW): 6 ``Trainer.train`` steps
   with the split backward, a profiled step, then 2 steps of a fresh trainer
   with the fused backward.

Launch counters, zeroed before each main path and read after it, show that
every path went through its kernels and never through a plain or eager
branch.

Every line of the standard output is one JSON object except the
``nvidia-smi`` line. The line before the last lists the kernels; the last
line is ``{"ok": true, "device": {...}}``. Any failing phase raises, so the
script exits non-zero and prints no result line.
"""

import json
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3 peak


def say(**obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# Tolerances of kernel vs plain version on the card, same inputs. An element
# may differ by ATOL + RTOL * |plain| + ROW_RTOL * max|plain| over its row
# (the head_dim vector of one query and head).
# fp32: both sides do fp32 arithmetic, only the order of sums differs.
# bf16: both sides accumulate in fp32 from the same bf16 inputs, but the
# tensor-core kernel rounds the probabilities to bf16 before the second
# product (as FlashAttention-2 does) and the output is rounded once more.
# Both errors are 2^-9 relative: the output's to the element, the
# probabilities' to the weighted values they multiply, whose size is the
# row's and not the element's. So the absolute term is tied to the row: a
# query that sees few keys has outputs of order 1 and may be off by 1e-2
# where an element happens to be near 0, a query that sees thousands has
# outputs of order 0.03 and is held to about 1e-3, which a lost or
# mis-weighted key tile exceeds.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-6}
RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ROW_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
LSE_TOL = 1e-4
TOLERANCE = {
    "bf16": [ATOL[torch.bfloat16], RTOL[torch.bfloat16],
             ROW_RTOL[torch.bfloat16]],
    "fp32": [ATOL[torch.float32], RTOL[torch.float32],
             ROW_RTOL[torch.float32]],
    "rule": "abs_err <= atol + rtol * |plain| + row_rtol * max_row |plain|",
}


def tolerance_use(got, want, dtype):
    """Largest share of its allowance any element uses; within tolerance
    when at most 1."""
    want = want.float()
    allowed = (ATOL[dtype] + RTOL[dtype] * want.abs()
               + ROW_RTOL[dtype] * want.abs().amax(dim=-1, keepdim=True))
    return float(((got.float() - want).abs() / allowed).max())


def within_tolerance(got, want, dtype):
    return tolerance_use(got, want, dtype) <= 1.0


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(phase="device", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from d9d_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    kernel_lib.load()
    say(phase="build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_seconds=round(kernel_lib.last_build_seconds, 2),
        sources=[f"d9d_tpu_torch/csrc/{p.name}" for p in kernel_lib.sources()])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def _rand(shape, dtype, gen):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def check_flash_fwd(gen):
    import torch.nn.functional as F

    from d9d_tpu_torch.ops.attention.flash import (
        apply_sinks,
        flash_attention,
        flash_attention_plain,
    )

    hq, hkv, d = 32, 8, 128
    cases = []
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def compare(tag, dtype, b, t, **kw):
        q = _rand((b, t, hq, d), dtype, gen)
        k = _rand((b, t, hkv, d), dtype, gen)
        v = _rand((b, t, hkv, d), dtype, gen)
        sinks = kw.pop("sinks", None)
        o, lse = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        op, lsep = flash_attention_plain(q, k, v, **kw)
        if sinks is not None:
            o, lse = apply_sinks(o, lse, sinks)
            op, lsep = apply_sinks(op, lsep, sinks)
        err, lerr = max_err(o, op), max_err(lse, lsep)
        use = tolerance_use(o, op, dtype)
        if not (torch.isfinite(o.float()).all() and use <= 1.0
                and lerr <= LSE_TOL):
            raise AssertionError(
                f"flash_fwd {tag} {dtype}: max_abs_err {err} uses {use} of "
                f"its tolerance, lse err {lerr} (limit {LSE_TOL})")
        worst[dtype] = max(worst[dtype], err)
        cases.append({"case": tag, "dtype": str(dtype).split(".")[-1],
                      "shape": [b, t, hq, hkv, d], "max_abs_err": err,
                      "tolerance_use": use,
                      "lse_err": lerr,
                      "ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                    iters=5, warmup=1)})
        return q, k, v

    def segs(b, t, pads):
        pad = torch.tensor(pads, device="cuda")[:, None]
        return (torch.arange(t, device="cuda")[None, :] >= pad).to(torch.int32)

    for dtype in (torch.bfloat16, torch.float32):
        compare("causal", dtype, 2, 2048)
        s = segs(2, 2048, [0, 700])
        compare("segments", dtype, 2, 2048, q_segments=s, kv_segments=s)
        compare("window", dtype, 2, 2048, window_size=512)
        compare("sinks", dtype, 2, 2048,
                sinks=torch.randn(hq, device="cuda", generator=gen))
    # the shape generate's first prefill chunk gives the kernel: batch 4,
    # chunk 512, left-padded rows as segments
    pads = [0, 324, 124, 511]
    s = segs(4, 512, pads)
    compare("prefill_chunk", torch.float32, 4, 512, q_segments=s,
            kv_segments=s)
    q, k, v = compare("prefill_chunk", torch.bfloat16, 4, 512, q_segments=s,
                      kv_segments=s)

    ms = time_ms(lambda: flash_attention(q, k, v, q_segments=s, kv_segments=s))
    plain_ms = time_ms(
        lambda: flash_attention_plain(q, k, v, q_segments=s, kv_segments=s),
        iters=5)
    # the same function through one library call: boolean mask = causal and
    # equal segments, kv heads repeated for the group beforehand
    t = 512
    causal = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    mask = (causal[None] & (s[:, :, None] == s[:, None, :]))[:, None]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    o, _ = flash_attention(q, k, v, q_segments=s, kv_segments=s)
    lib_err = max_err(lib.transpose(1, 2), o)
    if not within_tolerance(lib.transpose(1, 2), o, torch.bfloat16):
        raise AssertionError(f"flash_fwd vs library call: {lib_err}")
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))

    # least time: visible (query, key) pairs of this mask, 4*D flops each
    pairs = sum(p * (p + 1) // 2 + (t - p) * (t - p + 1) // 2 for p in pads)
    flops = 4.0 * hq * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 4 * hq * t * 4 \
        + 2 * s.numel() * 4
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "d9d_tpu/ops/attention/pallas_flash.py:437",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms, "library_max_abs_diff": lib_err,
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "timed_shape": {"B": 4, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
                        "dtype": "bfloat16", "segments": True},
        "bound_from": {"flops": flops, "bytes": nbytes},
    }


def check_flash_decode(gen):
    import torch.nn.functional as F

    from d9d_tpu_torch.ops.attention.decode import (
        flash_decode,
        flash_decode_bytes,
        flash_decode_plain,
    )

    b, hq, hkv, s_len, d = 8, 32, 8, 4096, 128
    cases = []
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def compare(tag, dtype, t, start, bb=b, **kw):
        q = _rand((bb, t, hq, d), dtype, gen)
        kc = _rand((bb, hkv, s_len, d), dtype, gen)
        vc = _rand((bb, hkv, s_len, d), dtype, gen)
        o, lse = flash_decode(q, kc, vc, start=start, **kw)
        torch.cuda.synchronize()
        op, lsep = flash_decode_plain(q, kc, vc, start=start, **kw)
        err, lerr = max_err(o, op), max_err(lse, lsep)
        use = tolerance_use(o, op, dtype)
        if not (torch.isfinite(o.float()).all() and use <= 1.0
                and lerr <= LSE_TOL):
            raise AssertionError(
                f"flash_decode {tag} {dtype}: max_abs_err {err} uses {use} of "
                f"its tolerance, lse err {lerr} (limit {LSE_TOL})")
        worst[dtype] = max(worst[dtype], err)
        cases.append({"case": tag, "dtype": str(dtype).split(".")[-1],
                      "shape": [bb, t, hq, hkv, s_len, d],
                      "max_abs_err": err,
                      "tolerance_use": use,
                      "lse_err": lerr,
                      "ms": time_ms(
                          lambda: flash_decode(q, kc, vc, start=start, **kw),
                          iters=5, warmup=1)})
        return q, kc, vc, o

    def spread(t, bb=b):  # per-row write indices spread over the cache
        return torch.linspace(0, s_len - t, bb, device="cuda").to(torch.int32)

    # left-padded rows: the first `pad` slots of a row are dead; row 0 has
    # every slot at or before its position dead (fully masked row -> zeros)
    valid = torch.arange(s_len, device="cuda")[None, :] >= torch.tensor(
        [1, 0, 3, 0, 17, 0, 200, 5], device="cuda")[:, None]
    for dtype in (torch.bfloat16, torch.float32):
        compare("step", dtype, 1, spread(1))
        compare("chunk64", dtype, 64, spread(64))
        _, _, _, o = compare("step_kv_valid", dtype, 1, spread(1),
                             kv_valid=valid)
        if not bool((o[0] == 0).all()):
            raise AssertionError("fully masked row is not exact zeros")
        compare("scalar_start_window", dtype, 1,
                torch.tensor(3000, device="cuda", dtype=torch.int32),
                window_size=1024)
        # the continuation chunk generate gives the kernel: batch 4, 512
        # new tokens on top of 512 cached ones
        compare("continuation_chunk512", dtype, 512,
                torch.tensor(512, device="cuda", dtype=torch.int32), bb=4,
                kv_valid=valid[:4])
    start = spread(1)
    start[0] = 2048  # timed call: no dead row
    q, kc, vc, _ = compare("step_timed", torch.bfloat16, 1, start,
                           kv_valid=valid)

    ms = time_ms(lambda: flash_decode(q, kc, vc, start=start, kv_valid=valid),
                 iters=50)
    plain_ms = time_ms(
        lambda: flash_decode_plain(q, kc, vc, start=start, kv_valid=valid),
        iters=5)
    pos = torch.arange(s_len, device="cuda")[None, :]
    mask = ((pos <= start[:, None]) & valid)[:, None, None, :]
    qh = q.transpose(1, 2)
    kh = kc.repeat_interleave(hq // hkv, dim=1)
    vh = vc.repeat_interleave(hq // hkv, dim=1)
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    o, _ = flash_decode(q, kc, vc, start=start, kv_valid=valid)
    lib_err = max_err(lib.transpose(1, 2), o)
    if not within_tolerance(lib.transpose(1, 2), o, torch.bfloat16):
        raise AssertionError(f"flash_decode vs library call: {lib_err}")
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        iters=50)

    nbytes = flash_decode_bytes(start, 1, b, hq, hkv, d, 2) + b * s_len * 4
    flops = 4.0 * hq * d * float((start.cpu().to(torch.int64) + 1).sum())
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/flash_decode.cu",
        "replaces": "d9d_tpu/ops/attention/pallas_decode.py:290",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms, "library_max_abs_diff": lib_err,
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "timed_shape": {"B": b, "T": 1, "Hq": hq, "Hkv": hkv, "S": s_len,
                        "D": d, "dtype": "bfloat16", "kv_valid": True,
                        "start": start.tolist()},
        "bound_from": {"flops": flops, "bytes": nbytes},
    }


# Tolerances of the backward kernels vs their plain version, same inputs.
# Same rule as above, other constants. The backward kernels multiply in
# exact fp32 (bf16 inputs are widened, not rounded further) and accumulate
# in fp32 as the plain version does, so the two differ in the order of sums
# only — and the fused dq in the order its atomic adds land — and then each
# rounds its fp32 result to the output dtype once. In bf16 two fp32 values
# that close may still round to neighbouring bf16 values: one bf16 step,
# 2^-7 of the element. The order of sums costs far less than 2^-12 of the
# row's size. A lost 64-key tile (dq) or a lost 64-row tile of one query
# head (dk, dv) costs a few percent of the row: the negative controls below
# emulate both with the plain version and must break the rule.
BWD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-6}
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
BWD_ROW_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -12}
BWD_TOLERANCE = {
    "bf16": [BWD_ATOL[torch.bfloat16], BWD_RTOL[torch.bfloat16],
             BWD_ROW_RTOL[torch.bfloat16]],
    "fp32": [BWD_ATOL[torch.float32], BWD_RTOL[torch.float32],
             BWD_ROW_RTOL[torch.float32]],
    "rule": TOLERANCE["rule"],
}
H100_FP32_FLOPS = 67e12  # CUDA-core fp32 peak (exact fp32 products)


def bwd_tolerance_use(got, want, dtype):
    want = want.float()
    allowed = (BWD_ATOL[dtype] + BWD_RTOL[dtype] * want.abs()
               + BWD_ROW_RTOL[dtype] * want.abs().amax(dim=-1, keepdim=True))
    return float(((got.float() - want).abs() / allowed).max())


def _bwd_inputs(gen, dtype, b, t, hq, hkv, d, **kw):
    from d9d_tpu_torch.ops.attention.flash import flash_attention

    q = _rand((b, t, hq, d), dtype, gen)
    k = _rand((b, t, hkv, d), dtype, gen)
    v = _rand((b, t, hkv, d), dtype, gen)
    do = _rand((b, t, hq, d), dtype, gen)
    o, lse = flash_attention(q, k, v, **kw)
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float()).contiguous()
    return q, k, v, do, o, lse, delta


def _bwd_work(q, k, kw, dtype):
    """Visible (query, key) pairs of this call's mask, and the least time
    of each kernel's work: 2*D flops per pair for each of its products (dq
    kernel 3: s, dp, dq; dk/dv kernel 4: s, dp, dv, dk; fused 5) at the
    dtype's peak (bf16 tensor cores; fp32 CUDA cores for exact fp32), or
    the bytes it must move (inputs once, its outputs once) at 3.35 TB/s,
    whichever is larger."""
    from d9d_tpu_torch.ops.attention.flash import _mask

    b, t, hq, d = q.shape
    mask = _mask(t, t, q.device, kw.get("causal", True),
                 kw.get("window_size"), kw.get("q_segments"),
                 kw.get("kv_segments"))
    pairs = float(mask.expand(b, 1, 1, t, t).sum()) * hq
    el = q.element_size()
    ins = (2 * q.numel() + 2 * k.numel()) * el + 2 * b * hq * t * 4
    if kw.get("q_segments") is not None:
        ins += 2 * b * t * 4
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_FP32_FLOPS
    out = {}
    for name, products, outs in (("flash_bwd_dq", 3, q.numel()),
                                 ("flash_bwd_dkv", 4, 2 * k.numel()),
                                 ("flash_bwd_fused", 5,
                                  q.numel() + 2 * k.numel())):
        flops = products * 2.0 * d * pairs
        nbytes = ins + outs * el
        by_ops, by_bytes = flops / peak, nbytes / H100_BYTES_PER_S
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": 1e3 * max(by_ops, by_bytes),
                     "bound_by": "operations" if by_ops >= by_bytes
                     else "bytes"}
    return pairs, out


def _time_bwd_kernels(q, k, v, do, lse, delta, kw, iters=5):
    """ms of each backward kernel alone (the fused one into a preallocated
    fp32 dq; its wrapper adds a zero fill and a cast)."""
    from d9d_tpu_torch.ops.attention import flash as F

    d = q.shape[-1]
    qs, ks = kw.get("q_segments"), kw.get("kv_segments")
    if qs is not None:
        qs, ks = qs.to(torch.int32).contiguous(), ks.to(torch.int32).contiguous()
    dq = torch.empty_like(q)
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = 0 if q.dtype == torch.float32 else 1
    scale = kw.get("softmax_scale") or d ** -0.5

    def launch(kernel):
        F._launch_bwd(kernel, q, k, v, do, lse, delta, qs, ks,
                      dq32 if kernel == 2 else dq, dk, dv, code, scale,
                      kw.get("causal", True), kw.get("window_size"))

    return {
        "flash_bwd_dq": time_ms(lambda: launch(0), iters=iters, warmup=1),
        "flash_bwd_dkv": time_ms(lambda: launch(1), iters=iters, warmup=1),
        "flash_bwd_fused": time_ms(lambda: launch(2), iters=iters, warmup=1),
    }


def _lost_tile_controls(q, k, v, do, o, lse, delta, want, dtype):
    """tolerance_use of the plain backward with one tile's contribution
    removed, against the full plain backward: keys 0..63 dropped from every
    dq row, and the last 64 query rows of head 0 dropped from dk and dv.
    Causal; must exceed 1."""
    from d9d_tpu_torch.ops.attention.flash import NEG_BIG, flash_attention_bwd_plain

    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qf = q.float().reshape(b, t, hkv, g, d)
    kt, vt = k[:, :64].float(), v[:, :64].float()
    s = torch.einsum("bthgd,bshd->bhgts", qf, kt) * scale
    vis = (torch.arange(64, device=q.device)[None, :]
           <= torch.arange(t, device=q.device)[:, None])
    s = torch.where(vis, s, torch.full_like(s, NEG_BIG))
    p = torch.exp(s - lse.reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bthgd,bshd->bhgts", do.float().reshape(b, t, hkv, g, d), vt)
    ds = p * (dp - delta.reshape(b, hkv, g, t, 1)) * scale
    tile = torch.einsum("bhgts,bshd->bthgd", ds, kt).reshape(b, t, hq, d)
    dq_lost = (want[0].float() - tile).to(dtype)
    do_l = do.clone()
    do_l[:, t - 64:, 0] = 0
    delta_l = torch.einsum("bthd,bthd->bht", do_l.float(), o.float()).contiguous()
    _, dk_l, dv_l = flash_attention_bwd_plain(q, k, v, do_l, lse, delta_l)
    return {"dq_without_key_tile_0": bwd_tolerance_use(dq_lost, want[0], dtype),
            "dk_without_last_row_tile_of_head_0":
                bwd_tolerance_use(dk_l, want[1], dtype),
            "dv_without_last_row_tile_of_head_0":
                bwd_tolerance_use(dv_l, want[2], dtype)}


def check_flash_bwd(gen):
    import torch.nn.functional as F

    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    hq, hkv, d = 32, 8, 128
    cases = []
    worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
             for n in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")}
    worst_use = {n: 0.0 for n in worst}

    def segs(b, t, pads):
        pad = torch.tensor(pads, device="cuda")[:, None]
        return (torch.arange(t, device="cuda")[None, :] >= pad).to(torch.int32)

    def compare(tag, dtype, b, t, hq_=hq, hkv_=hkv, d_=d, **kw):
        q, k, v, do, o, lse, delta = _bwd_inputs(gen, dtype, b, t, hq_, hkv_,
                                                 d_, **kw)
        want = flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
        split = flash_attention_bwd(q, k, v, do, lse, delta, **kw)
        fused = flash_attention_bwd(q, k, v, do, lse, delta, fused=True, **kw)
        torch.cuda.synchronize()
        row = {"case": tag, "dtype": str(dtype).split(".")[-1],
               "shape": [b, t, hq_, hkv_, d_]}
        for name, got, which in (("flash_bwd_dq", split, (0,)),
                                 ("flash_bwd_dkv", split, (1, 2)),
                                 ("flash_bwd_fused", fused, (0, 1, 2))):
            errs = [max_err(got[i], want[i]) for i in which]
            uses = [bwd_tolerance_use(got[i], want[i], dtype) for i in which]
            finite = all(bool(torch.isfinite(got[i].float()).all())
                         for i in which)
            if not finite or max(uses) > 1.0:
                raise AssertionError(
                    f"{name} {tag} {dtype}: max_abs_err {errs} uses {uses} "
                    f"of its tolerance (finite: {finite})")
            worst[name][dtype] = max(worst[name][dtype], max(errs))
            worst_use[name] = max(worst_use[name], max(uses))
            row[name] = {"max_abs_err": max(errs), "tolerance_use": max(uses)}
        pairs, work = _bwd_work(q, k, kw, dtype)
        ms = _time_bwd_kernels(q, k, v, do, lse, delta, kw)
        for name in work:
            row[name].update(ms=ms[name], bound_ms=work[name]["bound_ms"],
                             bound_by=work[name]["bound_by"])
        row["visible_pairs"] = pairs
        cases.append(row)
        return (q, k, v, do, o, lse, delta), want, work, ms

    for dtype in (torch.bfloat16, torch.float32):
        compare("causal", dtype, 2, 2048)
        compare("window512", dtype, 2, 2048, window_size=512)
        s = segs(2, 2048, [0, 700])
        compare("segments_padding", dtype, 2, 2048, q_segments=s, kv_segments=s)
        compare("t1000", dtype, 2, 1000)
        compare("d64", dtype, 2, 2048, d_=64)
        # non-causal, query segments that match no key at a few positions:
        # those rows see no key (forward zeros, lse = -1e30) and the
        # ungated backward gives them p = 1 on every key, as the TPU
        # kernels do; without causal or window every kernel visits every
        # key, so all three agree with the plain version exactly there
        ks = torch.zeros((2, 512), dtype=torch.int32, device="cuda")
        qs = ks.clone()
        qs[:, [5, 300, 511]] = 9
        compare("no_visible_key_rows", dtype, 2, 512, causal=False,
                q_segments=qs, kv_segments=ks)

    # the timed shape: bf16, B=2, T=2048, causal — the main path's shape
    (q, k, v, do, o, lse, delta), want, work, ms = compare(
        "timed_causal", torch.bfloat16, 2, 2048)
    controls = _lost_tile_controls(q, k, v, do, o, lse, delta, want,
                                   torch.bfloat16)
    if min(controls.values()) <= 1.0:
        raise AssertionError(f"a lost tile passes the bf16 rule: {controls}")
    plain_ms = time_ms(
        lambda: flash_attention_bwd_plain(q, k, v, do, lse, delta), iters=3,
        warmup=1)
    split_ms = time_ms(lambda: flash_attention_bwd(q, k, v, do, lse, delta),
                       iters=5, warmup=1)
    fused_wrapper_ms = time_ms(
        lambda: flash_attention_bwd(q, k, v, do, lse, delta, fused=True),
        iters=5, warmup=1)
    # library yardstick: the backward of one scaled_dot_product_attention
    # call at the same shape, causal, kv heads repeated beforehand; timed as
    # (forward + backward) - forward, 10 calls each
    g = hq // hkv
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_()
    doh = do.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def lib_fwd_bwd():
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True).backward(doh)

    lib_fwd_bwd()
    torch.cuda.synchronize()
    lib_dq = qh.grad.transpose(1, 2)
    lib_err = max_err(lib_dq, want[0])
    library_ms = time_ms(lib_fwd_bwd, iters=10) - time_ms(lib_fwd, iters=10)
    kernels = []
    for name, src_line in (("flash_bwd_dq", 583), ("flash_bwd_dkv", 602),
                           ("flash_bwd_fused", 548)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "d9d_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"d9d_tpu/ops/attention/pallas_flash.py:{src_line}",
            "max_abs_err": worst[name][torch.bfloat16],
            "max_abs_err_fp32": worst[name][torch.float32],
            "tolerance_use": worst_use[name],
            "ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": work[name]["bound_ms"],
            "bound_by": work[name]["bound_by"],
            "library_ms": library_ms,
        })
    return kernels, {
        "cases": cases, "tolerance": BWD_TOLERANCE,
        "negative_controls": controls,
        "timed_shape": {"B": 2, "T": 2048, "Hq": hq, "Hkv": hkv, "D": d,
                        "dtype": "bfloat16", "causal": True},
        "split_wrapper_ms": split_ms, "fused_wrapper_ms": fused_wrapper_ms,
        "plain_ms_is": "the plain backward, all three gradients",
        "library_ms_is": "scaled_dot_product_attention forward+backward "
                         "minus forward, causal, kv heads repeated",
        "library_dq_max_abs_diff": lib_err,
        "bound_from": {n: {"flops": w["flops"], "bytes": w["bytes"]}
                       for n, w in work.items()},
    }


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1, detail1 = check_flash_fwd(gen)
    say(phase="kernels", kernel="flash_fwd", **detail1)
    k2, detail2 = check_flash_decode(gen)
    say(phase="kernels", kernel="flash_decode", **detail2)
    bwd, detail3 = check_flash_bwd(gen)
    say(phase="kernels", kernel="flash_bwd", **detail3)
    torch.cuda.empty_cache()
    return [k1, k2, *bwd]


# ---------------------------------------------------------------------------
# launch counters


KERNEL_NAMES = ("flash_fwd", "flash_decode", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_bwd_fused")


def reset_counters(model=None):
    from d9d_tpu_torch.ops.attention.decode import flash_decode
    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention,
        flash_attention_bwd,
    )

    for fn in (flash_attention, flash_decode):
        fn.launches = 0
        fn.plain_calls = 0
    for name in ("dq_launches", "dkv_launches", "fused_launches",
                 "plain_calls"):
        setattr(flash_attention_bwd, name, 0)
    if model is not None:
        model.sdpa.eager_calls = 0


def read_counters(model):
    from d9d_tpu_torch.ops.attention.decode import flash_decode
    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention,
        flash_attention_bwd,
    )

    return {
        "flash_fwd": flash_attention.launches,
        "flash_decode": flash_decode.launches,
        "flash_bwd_dq": flash_attention_bwd.dq_launches,
        "flash_bwd_dkv": flash_attention_bwd.dkv_launches,
        "flash_bwd_fused": flash_attention_bwd.fused_launches,
        "plain_calls": flash_attention.plain_calls + flash_decode.plain_calls
        + flash_attention_bwd.plain_calls,
        "eager_calls": model.sdpa.eager_calls,
    }


def counts(**launches):
    """A counter dict: the given launches, every other count 0."""
    out = dict.fromkeys(KERNEL_NAMES + ("plain_calls", "eager_calls"), 0)
    out.update(launches)
    return out


# ---------------------------------------------------------------------------
# phase 4: small end-to-end agreement


def phase_small_e2e():
    from d9d_tpu_torch.loop import ContinuousBatcher, generate
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig

    cfg = Qwen3DenseConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512,
    )
    dml = 96
    gpu = Qwen3DenseCausalLM(cfg, decode_max_length=dml, dtype=torch.float32,
                             seed=7)
    # the same weights forced through the plain versions: a copy on the CPU
    cpu = Qwen3DenseCausalLM(cfg, decode_max_length=dml, dtype=torch.float32,
                             device="cpu", seed=7)
    cpu.load_state_dict(gpu.state_dict())

    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 1024, (3, 40), generator=g)
    lengths = torch.tensor([40, 17, 29])
    kw = dict(max_new_tokens=12, prompt_lengths=lengths, prefill_chunk_size=16)
    reset_counters(gpu)
    got = generate(gpu, ids, **kw)
    torch.cuda.synchronize()
    on_card = read_counters(gpu)
    want = generate(cpu, ids, **kw)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(
            f"small model: greedy tokens differ\n{got.cpu()}\n{want}")
    if on_card != counts(flash_fwd=2, flash_decode=2 * (2 + 11)):
        raise AssertionError(f"small model: unexpected counters {on_card}")

    # teacher-forced logits: prefill + a continuation chunk + one step
    pos = torch.clamp(torch.arange(40)[None, :] - (40 - lengths)[:, None], min=0)
    valid = (torch.arange(dml)[None, :] >= (40 - lengths)[:, None])[
        :, None, None, :]
    from d9d_tpu_torch.nn.decode_flags import continuation_chunk

    def forced(model):
        dev = model.device
        cache = model.init_cache(3)
        i, p, m = ids.to(dev), pos.to(dev).to(torch.int32), valid.to(dev)
        a = model.logits_last(i[:, :24], p[:, :24], mask=m, cache=cache)
        with continuation_chunk():
            b = model.logits_last(i[:, 24:39], p[:, 24:39], mask=m, cache=cache)
        c = model.logits_last(i[:, 39:], p[:, 39:], mask=m, cache=cache)
        return torch.cat([a, b, c], dim=1).cpu()

    logit_err = max_err(forced(gpu), forced(cpu))
    if logit_err > 1e-3:
        raise AssertionError(f"small model: logits differ by {logit_err}")

    # the batcher against generate, both on the card (the parity contract)
    prompts = [ids[0, :n].tolist() for n in (5, 9, 3, 12, 7)]
    budgets = [6, 10, 4, 8, 12]
    batcher = ContinuousBatcher(gpu, batch_size=2, chunk_size=4)
    rids = [batcher.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    out = batcher.drain()
    for rid, p, n in zip(rids, prompts, budgets):
        alone = generate(gpu, torch.tensor([p]), max_new_tokens=n)[0].tolist()
        if out[rid] != alone:
            raise AssertionError(
                f"small model: batcher stream {out[rid]} != generate {alone}")
    say(phase="small_e2e", tokens_identical=True, logits_max_abs_err=logit_err,
        logits_tolerance=1e-3, batcher_matches_generate=True,
        counters=on_card)


# ---------------------------------------------------------------------------
# phase 5: full width


def phase_full_width():
    import random

    from d9d_tpu_torch.loop import ContinuousBatcher, generate
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig

    cfg = Qwen3DenseConfig.qwen3_8b()
    layers = cfg.num_layers
    dml = 4096
    t0 = time.perf_counter()
    model = Qwen3DenseCausalLM(cfg, decode_max_length=dml,
                               dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(phase="full_width", model="qwen3_8b", layers=layers,
        params=n_params, init_seconds=round(time.perf_counter() - t0, 2),
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()))
    torch.cuda.reset_peak_memory_stats()

    # (a) generate: batch 4, ragged prompts up to 1024, chunked prefill
    g = torch.Generator().manual_seed(11)
    p_len, new = 1024, 32
    ids = torch.randint(0, cfg.vocab_size, (4, p_len), generator=g)
    lengths = torch.tensor([1024, 700, 900, 513])
    kw = dict(prompt_lengths=lengths, prefill_chunk_size=512)
    reset_counters(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = generate(model, ids, max_new_tokens=1, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    got = read_counters(model)
    # per generate call: chunk 0 rides flash_fwd, chunk 1 and every decode
    # step ride flash_decode, once per layer
    want = counts(flash_fwd=2 * layers,
                  flash_decode=2 * layers + (new - 1) * layers)
    if got != want:
        raise AssertionError(f"generate: counters {got}, expected {want}")
    out_c = out.cpu()
    if out_c.shape != (4, new) or out_c.dtype != torch.int32 \
            or int(out_c.min()) < 0 or int(out_c.max()) >= cfg.vocab_size:
        raise AssertionError("generate: malformed output")
    if not torch.equal(out_c[:, 0], first.cpu()[:, 0]):
        raise AssertionError("generate: two prefills disagree")
    decode_s = max(total_s - prefill_s, 1e-9)
    launches = dict(got)
    say(phase="full_width", entry="generate", batch=4,
        prompt_tokens=int(lengths.sum()), new_tokens=4 * new,
        prefill_seconds=prefill_s,
        prefill_tokens_per_s=float(lengths.sum()) / prefill_s,
        decode_seconds=decode_s,
        decode_tokens_per_s=4 * (new - 1) / decode_s,
        ms_per_decode_step=1e3 * decode_s / (new - 1), counters=got)

    # (b) ContinuousBatcher: 12 requests over 8 slots
    rnd = random.Random(5)
    reqs = [([rnd.randrange(cfg.vocab_size)
              for _ in range(rnd.randint(16, 128))], rnd.randint(16, 48))
            for _ in range(12)]
    reset_counters(model)
    batcher = ContinuousBatcher(model, batch_size=8, chunk_size=8)
    rids = [batcher.submit(p, max_new_tokens=n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = batcher.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    got = read_counters(model)
    stats = batcher.stats
    for rid, (_p, n) in zip(rids, reqs):
        toks = outputs[rid]
        if len(toks) != n or min(toks) < 0 or max(toks) >= cfg.vocab_size:
            raise AssertionError(
                f"batcher: request {rid} returned {len(toks)} of {n} tokens")
    want = counts(flash_decode=stats.device_steps * layers)
    if got != want or stats.readbacks != stats.chunks:
        raise AssertionError(f"batcher: counters {got}, expected {want}")
    for name in launches:
        launches[name] += got[name]
    say(phase="full_width", entry="ContinuousBatcher", batch_size=8,
        chunk_size=8, requests=len(reqs),
        prompt_tokens=sum(len(p) for p, _ in reqs),
        emitted_tokens=stats.emitted_tokens, seconds=serve_s,
        emitted_tokens_per_s=stats.emitted_tokens / serve_s,
        ms_per_device_step=1e3 * serve_s / stats.device_steps,
        stats={"host_dispatches": stats.host_dispatches,
               "readbacks": stats.readbacks, "chunks": stats.chunks,
               "device_steps": stats.device_steps,
               "dispatches_per_1k_tokens": stats.dispatches_per_1k_tokens,
               "readbacks_per_1k_tokens": stats.readbacks_per_1k_tokens,
               "slot_utilization": stats.slot_utilization},
        counters=got,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    say(phase="profile", **profile_decode_steps(model))
    return launches


def profile_decode_steps(model, batch=8, steps=4):
    """Where a full-width decode step spends its time: ``steps`` single-token
    steps of a batch-8 cache at ~1k tokens under ``torch.profiler``. Reports
    the wall time per step (taken without the profiler), the device's busy
    time per step (sum of kernel times) and the share of the step the device
    sat idle; null where the
    profiler recorded no device activity. Runs after the counters of the
    main path were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(batch, per_row=True)
    cache.index.fill_(1000)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=model.device)
    pos = torch.full((batch, 1), 1000, dtype=torch.int32, device=model.device)

    def run():
        for _ in range(steps):
            model.logits_last(tok, pos, cache=cache)
        torch.cuda.synchronize()

    run()  # warm
    cache.index.fill_(1000)
    t0 = time.perf_counter()
    run()  # the wall time is taken without the profiler's overhead
    wall = time.perf_counter() - t0
    cache.index.fill_(1000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # device rows only: an operator row repeats its kernels' device time
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.key.startswith("aten::")),
                      key=lambda e: -e.count)
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    out = {
        "what": f"{steps} decode steps, batch {batch}, cache at 1000 tokens",
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": None, "device_idle_share": None,
        "device_kernels_per_step": None, "top_device_ops": None,
        "top_host_ops_by_calls": [
            {"name": e.key, "calls_per_step": e.count / steps}
            for e in host_ops[:12]],
    }
    if busy_us > 0:
        busy_ms = busy_us / 1e3 / steps
        out.update(
            device_busy_ms_per_step=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / (1e3 * wall / steps)),
            device_kernels_per_step=n_kernels / steps,
            top_device_ops=[
                {"name": e.key[:60],
                 "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps}
                for e in top[:8]],
        )
    return out


# ---------------------------------------------------------------------------
# training: small end-to-end agreement, then full width


def _train_parts():
    from d9d_tpu_torch.loop import ModelProvider
    from d9d_tpu_torch.lr_scheduler import (
        CurveCosineConfig,
        CurveLinearConfig,
        PiecewiseSchedulerConfig,
        RestPhaseConfig,
        StepPhaseConfig,
    )
    from d9d_tpu_torch.loop import PiecewiseLRConfig, build_lr_schedule
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM
    from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig
    from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend

    class Provider(ModelProvider):
        """The model on the context's device; weights from ``state`` when
        given, else drawn from ``seed`` on that device."""

        def __init__(self, cfg, dtype, fused_bwd, state=None, seed=0):
            self.cfg, self.dtype, self.fused_bwd = cfg, dtype, fused_bwd
            self.state, self.seed = state, seed

        def build_module(self, ctx):
            model = Qwen3DenseCausalLM(
                self.cfg, build_sdpa_backend(
                    SdpaFlashConfig(fused_bwd=self.fused_bwd)),
                dtype=self.dtype, param_dtype=torch.float32,
                device=ctx.device,
                seed=None if self.state is not None else self.seed)
            if self.state is not None:
                model.load_state_dict(self.state)
            return model

    def schedule(base_lr, total_steps):
        # warmup over 2 steps from 0.1x, cosine to 0.1x over the rest
        return build_lr_schedule(PiecewiseLRConfig(
            base_lr=base_lr, schedule=PiecewiseSchedulerConfig(
                initial_multiplier=0.1,
                phases=(StepPhaseConfig(2, 1.0, CurveLinearConfig()),
                        RestPhaseConfig(0.1, CurveCosineConfig())))),
            total_steps=total_steps)

    return Provider, schedule


class _Batches:
    """Repeating-pattern token batches from a numpy seed: each row repeats
    a random 64-token pattern drawn from a fixed set of 256 token ids, so
    that a few steps can already learn which tokens occur."""

    def __init__(self, vocab, n, gbs, seq, seed, loss_mask=False):
        import numpy as np

        rng = np.random.default_rng(seed)
        tokens = rng.choice(vocab, size=min(256, vocab), replace=False)
        self.batches = []
        for _ in range(n):
            pat = tokens[rng.integers(0, len(tokens), (gbs, 64))]
            ids = np.tile(pat, (1, (seq + 1) // 64 + 1))[:, :seq + 1]
            b = {"input_ids": ids}
            if loss_mask:
                b["loss_mask"] = (rng.random((gbs, seq + 1)) > 0.2).astype(
                    np.int32)
            self.batches.append(b)

    def build(self):
        return iter(self.batches)


def phase_small_e2e_train():
    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig

    # exact fp32 products on the card (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    Provider, schedule = _train_parts()
    cfg = Qwen3DenseConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512,
    )
    state = Qwen3DenseCausalLM(cfg, dtype=torch.float32,
                               param_dtype=torch.float32, device="cpu",
                               seed=7).state_dict()
    data = _Batches(1024, 3, 4, 128, seed=21, loss_mask=True)

    def run(device, fused, steps):
        trainer = Trainer(
            ctx=MeshParameters().build([device]),
            config=TrainerConfig(global_batch_size=4, microbatch_size=2,
                                 seq_len=128, total_steps=steps, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=Provider(cfg, torch.float32, fused, state=state),
            dataset_provider=data, task=CausalLMTask(),
            optimizer_provider=AdamWProvider(weight_decay=0.1),
            learning_rate=schedule(1e-3, 3))
        reset_counters(trainer.module)
        hist = trainer.train()
        torch.cuda.synchronize()
        return hist, read_counters(trainer.module)

    card, on_card = run("cuda", False, 3)
    # 2 layers x 2 microbatches x 3 steps; the forward runs twice (remat)
    if on_card != counts(flash_fwd=24, flash_bwd_dq=12, flash_bwd_dkv=12):
        raise AssertionError(f"small train: unexpected counters {on_card}")
    host, _ = run("cpu", False, 3)
    fused, on_card_fused = run("cuda", True, 1)
    if on_card_fused != counts(flash_fwd=8, flash_bwd_fused=4):
        raise AssertionError(f"small train: fused counters {on_card_fused}")
    tol = 1e-4  # fp32 on both sides; matmuls and sums in other orders
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                  for a, b in zip(card, host))
           for k in ("loss", "grad_norm")}
    fused_rel = {k: abs(fused[0][k] - card[0][k]) / max(abs(card[0][k]), 1e-12)
                 for k in ("loss", "grad_norm")}
    if max(rel.values()) > tol or max(fused_rel.values()) > tol:
        raise AssertionError(
            f"small train: card vs CPU {rel}, fused vs split {fused_rel} "
            f"(tolerance {tol})")
    say(phase="small_e2e_train", steps=3,
        card=[{k: h[k] for k in ("step", "loss", "grad_norm")} for h in card],
        cpu=[{k: h[k] for k in ("step", "loss", "grad_norm")} for h in host],
        max_rel_diff_card_vs_cpu=rel, fused_step1_rel_diff=fused_rel,
        tolerance=tol, counters=on_card, counters_fused=on_card_fused)


def profile_train_step(trainer, raw_batch):
    """Where a full-width train step spends its time: one
    ``Trainer.run_step`` under ``torch.profiler`` (after the main path's
    counters were read), and one without it for the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_step(raw_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_step(raw_batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    out = {"what": "one Trainer.run_step (2 microbatches)",
           "wall_ms_per_step": 1e3 * wall, "device_busy_ms_per_step": None,
           "device_idle_share": None, "device_kernels_per_step": None,
           "top_device_ops": None}
    if busy_us > 0:
        busy_ms = busy_us / 1e3
        out.update(
            device_busy_ms_per_step=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / (1e3 * wall)),
            device_kernels_per_step=sum(e.count for e in kernels),
            top_device_ops=[
                {"name": e.key[:60], "ms_per_step": e.self_device_time_total / 1e3,
                 "calls_per_step": e.count} for e in top[:10]],
        )
    return out


def phase_full_width_train():
    import dataclasses
    import gc
    import math
    import statistics

    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseConfig

    Provider, schedule = _train_parts()
    layers = 8  # of 36: fp32 params + grads + two Adam moments are 16 B/param
    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(), num_layers=layers)
    gbs, mbs, seq, steps = 4, 2, 2048, 6
    data = _Batches(cfg.vocab_size, steps + 2, gbs, seq, seed=5)

    def trainer_for(fused, total):
        return Trainer(
            ctx=MeshParameters().build(),
            config=TrainerConfig(global_batch_size=gbs, microbatch_size=mbs,
                                 seq_len=seq, total_steps=total, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=Provider(cfg, torch.bfloat16, fused, seed=0),
            dataset_provider=data, task=CausalLMTask(),
            optimizer_provider=AdamWProvider(weight_decay=0.1),
            learning_rate=schedule(3e-4, total))

    t0 = time.perf_counter()
    trainer = trainer_for(False, steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.module.parameters())
    say(phase="full_width_train", model="qwen3_8b", layers=layers,
        layers_reduced_from=36, params=n_params,
        state_bytes=16 * n_params, init_seconds=time.perf_counter() - t0,
        setup={"param_dtype": "float32", "dtype": "bfloat16",
               "remat": cfg.remat_policy, "global_batch_size": gbs,
               "microbatch_size": mbs, "seq_len": seq,
               "optimizer": "AdamW wd 0.1", "warmup_steps": 2})
    torch.cuda.reset_peak_memory_stats()
    reset_counters(trainer.module)
    hist = trainer.train()
    torch.cuda.synchronize()
    got = read_counters(trainer.module)
    per_step = layers * (gbs // mbs) * steps
    want = counts(flash_fwd=2 * per_step, flash_bwd_dq=per_step,
                  flash_bwd_dkv=per_step)
    if got != want:
        raise AssertionError(f"train: counters {got}, expected {want}")
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"train: bad history {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                   for a, b in zip(hist, hist[1:])]
    ms_step = 1e3 * statistics.median(walls[1:])
    launches = dict(got)
    say(phase="full_width_train", entry="Trainer.train", backward="split",
        steps=[{"step": h["step"], "loss": h["loss"],
                "grad_norm": h["grad_norm"]} for h in hist],
        ms_per_step=ms_step, ms_per_step_all=[1e3 * w for w in walls],
        tokens_per_s=gbs * seq / (ms_step / 1e3),
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got)
    say(phase="profile", **profile_train_step(trainer, data.batches[steps]))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = trainer_for(True, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(trainer.module)
    fhist = trainer.train()
    torch.cuda.synchronize()
    got = read_counters(trainer.module)
    per_step = layers * (gbs // mbs) * 2
    want = counts(flash_fwd=2 * per_step, flash_bwd_fused=per_step)
    if got != want:
        raise AssertionError(f"train fused: counters {got}, expected {want}")
    flosses = [h["loss"] for h in fhist]
    fnorms = [h["grad_norm"] for h in fhist]
    if not all(map(math.isfinite, flosses + fnorms)):
        raise AssertionError(f"train fused: bad history {flosses} {fnorms}")
    fwalls = [fhist[0]["wall_s"], fhist[1]["wall_s"] - fhist[0]["wall_s"]]
    say(phase="full_width_train", entry="Trainer.train", backward="fused",
        steps=[{"step": h["step"], "loss": h["loss"],
                "grad_norm": h["grad_norm"]} for h in fhist],
        step1_vs_split={"loss_rel_diff": abs(flosses[0] - losses[0]) / losses[0],
                        "grad_norm_rel_diff": abs(fnorms[0] - norms[0]) / norms[0]},
        ms_per_step_all=[1e3 * w for w in fwalls],
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got)
    for name, n in got.items():
        launches[name] += n
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main():
    import gc

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_small_e2e()
    phase_small_e2e_train()
    launches = phase_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in phase_full_width_train().items():
        launches[name] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if launches["plain_calls"] or launches["eager_calls"]:
        raise AssertionError(f"plain/eager branch taken: {launches}")
    say(phase="done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    say(kernels=kernels)
    say(ok=True, device={"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
