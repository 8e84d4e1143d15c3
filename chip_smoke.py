#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``d9d_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. Phases:

1. device — fail at once without a CUDA device; print the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build — compile the port's CUDA kernels from ``d9d_tpu_torch/csrc``;
3. kernels — hold each kernel against its plain PyTorch version on the card
   (bf16 and fp32, at the serving path's shapes), time kernel, plain version
   and one library call that computes the same function (a yardstick only —
   the port never calls it), and compute the card's least time for the work;
4. small end-to-end agreement — a narrow fp32 model on the card (through
   the kernels) against the same weights on the CPU (through the plain
   versions): greedy tokens identical, logits within tolerance; the batcher
   against ``generate`` on the card;
5. full width — Qwen3-8B (36 layers, random seeded bf16 weights): ``generate``
   on a ragged batch with chunked prefill, then a ``ContinuousBatcher`` that
   drains 12 requests; launch counters show the path went through the
   kernels and never through a plain or eager branch.

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


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1, detail1 = check_flash_fwd(gen)
    say(phase="kernels", kernel="flash_fwd", **detail1)
    k2, detail2 = check_flash_decode(gen)
    say(phase="kernels", kernel="flash_decode", **detail2)
    torch.cuda.empty_cache()
    return [k1, k2]


# ---------------------------------------------------------------------------
# launch counters


def counters():
    from d9d_tpu_torch.ops.attention.decode import flash_decode
    from d9d_tpu_torch.ops.attention.flash import flash_attention

    return {"flash_fwd": flash_attention, "flash_decode": flash_decode}


def reset_counters(model=None):
    for fn in counters().values():
        fn.launches = 0
        fn.plain_calls = 0
    if model is not None:
        model.sdpa.eager_calls = 0


def read_counters(model):
    c = counters()
    return {
        "flash_fwd": c["flash_fwd"].launches,
        "flash_decode": c["flash_decode"].launches,
        "plain_calls": c["flash_fwd"].plain_calls
        + c["flash_decode"].plain_calls,
        "eager_calls": model.sdpa.eager_calls,
    }


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
    if on_card["flash_fwd"] != 2 or on_card["flash_decode"] != 2 * (2 + 11) \
            or on_card["plain_calls"] or on_card["eager_calls"]:
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
    want = {"flash_fwd": 2 * layers,
            "flash_decode": 2 * layers + (new - 1) * layers,
            "plain_calls": 0, "eager_calls": 0}
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
    want = {"flash_fwd": 0, "flash_decode": stats.device_steps * layers,
            "plain_calls": 0, "eager_calls": 0}
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


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_small_e2e()
    launches = phase_full_width()
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
