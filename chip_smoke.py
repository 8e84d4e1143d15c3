#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``d9d_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. Phases:

1. device — fail at once without a CUDA device; print the card's name and
   power limit as ``nvidia-smi`` gives them, and its compute mode;
2. build — compile the port's CUDA kernels from ``d9d_tpu_torch/csrc``;
3. kernels — hold each kernel against its plain PyTorch version on the card
   (bf16 and fp32, at the main paths' shapes), time kernel, plain version
   and one library call that computes the same function (a yardstick only —
   the port never calls it), and compute the card's least time for the work:
   the flash forward and decode kernels, the paged decode kernel (bf16,
   fp32 and int8 pools, shuffled and shared page tables, pages of 4, 8 and
   16, with a lost-page negative control; both decode kernels at starts on
   tile edges, every case run twice and required equal bit for bit, their
   own device time read from the profiler beside the wrapper loop's, and
   the bf16 cluster core timed at each cluster size), the three flash backward kernels
   (dq, dk/dv and fused — bf16 on the tensor cores; every fused case run
   twice and required equal bit for bit, its dq being summed in a fixed
   order) and the three MoE expert-FFN kernels (aligned, gather,
   gather+combine, all three on the sm_90 core in bf16, two device kernels
   a call; the gather kernel required equal bit for bit to the aligned one
   on the same routing; the last read for its run-to-run spread; also at
   one decode step of 8 tokens and at i = 1600), the last two families
   with negative controls for their bf16 rules; the flash kernels
   also at Qwen3-30B-A3B's GQA group (g = 8) and the forward at the
   training shape (B=2, T=2048, causal) beside its bound and library call;
   the stochastic-rounding kernel bit for bit at 1, 1000003, 4096 x 12288
   and 151936 x 4096 elements (±0, denormals, ±inf, NaNs, the largest
   finite values), with its rule checked at 2^24 draws per fraction and a
   round-to-nearest negative control, and on FSDP's pieces at their index
   offsets (row and column pieces, bit for bit against the plain version
   and against the same elements of the whole tensor's rounding); the flash kernels at global offsets
   (B4, the ring-attention block) at Qwen3-8B heads on 4096-token chunks —
   diagonal, past, future, a straddling window, segments, non-causal with a
   negative shift; forward and the three backward kernels with cotangents
   from a downstream combine — then 4 chunks composed into causal attention
   over 16384 tokens against the whole-sequence kernels, with an
   offsets-zeroed negative control, and the main path's 8192-token block;
4. small end-to-end agreement — serving: a narrow fp32 model on the card
   (through the kernels) against the same weights on the CPU (through the
   plain versions): greedy tokens identical, logits within tolerance; the
   batcher against ``generate`` on the card; the paged batcher (fp32 and
   int8 pools, prefix hits) on the card against the CPU; the same serving
   paths for a narrow fp32 Qwen3-MoE model, once for each expert-FFN
   kernel. Training: 3 ``Trainer`` steps
   of a narrow fp32 model on the card against 3 on the CPU, loss and grad
   norm per step within tolerance, and a step with the fused backward
   against the split one; the same for a narrow fp32 Qwen3-MoE model, once
   for each expert-FFN kernel; one ``StochasticAdamW`` step on the card
   against the CPU (bf16 parameters, fp32 moments and gradients), then 3
   ``Trainer`` steps of narrow dense and MoE models with bf16 parameters;
5. full width, serving — Qwen3-8B (18 of its 36 layers, random seeded
   bf16 weights):
   ``generate`` on a ragged batch with chunked prefill, then a
   ``ContinuousBatcher`` that drains 12 requests; then paged serving on the
   same weights: 12 requests (prompts 16–384 tokens, 6 sharing a 256-token
   prefix) through the contiguous batcher and through
   ``ContinuousBatcher(page_size=16, prefix_cache=True)`` with bf16 and with
   int8 pools — tokens/s, prefix hits, pages in use, KV bytes per request,
   and the share of greedy tokens equal to the contiguous batcher's; then
   Qwen3-30B-A3B at full width and 24 of its 48 layers (random seeded bf16
   weights drawn on the card): ``generate`` on a ragged batch with chunked
   prefill once per expert-FFN kernel (aligned and gather tokens equal),
   12 shorter requests through the contiguous and paged (bf16, int8)
   batchers with the gather+combine kernel, and a profiled decode step;
6. full width, training — Qwen3-8B widths at 8 of its 36 layers (fp32
   parameters, bf16 compute, full remat, AdamW): 6 ``Trainer.train`` steps
   with the split backward, a profiled step, then 2 steps of a fresh trainer
   with the fused backward;
7. full width, MoE training — Qwen3-30B-A3B widths at 4 of its 48 layers
   (128 experts, top-8; same setup): 6 ``Trainer.train`` steps with the
   aligned expert-FFN kernel, a profiled step, then 2 steps each of fresh
   trainers with the gather and the gather+combine kernels;
8. full width, bf16 parameters — Qwen3-8B widths at 8 layers with bf16
   parameters (layer norms fp32) under ``StochasticAdamW``: 6 steps, a
   profiled step, 2 steps of a fresh trainer with bf16 moments; then
   Qwen3-30B-A3B widths at 4 layers, 2 steps. Every rounding of a
   parameter or bf16 moment goes through the stochastic-rounding kernel;
9. context parallelism — two child processes of this script
   (``--cp-worker``) share the card over gloo at ``cp_shard = 2``: one fp32
   step of Qwen3-8B widths at 1 layer through the ring against the same
   step in this process through the flash backend, then 2
   ``Trainer.train`` steps at 2 of 36 layers on 16384-token sequences
   (bf16 compute, fp32 parameters, full remat, AdamW); every attention goes
   through the ring and B4. Two ranks time-share one card: the phase shows
   correctness and times, not context-parallel scaling;
10. data parallelism — two child processes (``--dp-worker``) share the card
   over gloo at ``dp_shard = 2`` under ``fsdp_plan`` (each rank initializes
   and holds only its pieces of the parameters): 1 fp32 step of Qwen3-8B
   widths at 1 layer and 2 steps with bf16
   parameters under ``StochasticAdamW`` (B10 on the pieces), each against
   the same steps in this process on one device, then 1 ``Trainer.train``
   step at 2 of 36 layers (bf16 compute, fp32 parameters, full remat,
   AdamW) under the host profiler: ms per step, peak memory per rank and
   the share of the step's host time in FSDP's collective regions. Like
   phase 9 it shows correctness and times, not data-parallel scaling;
11. tensor parallelism — 2 and 4 child processes (``--tp-worker``) share
   the card over gloo: ``tp 2``, ``dp_shard 2 x tp 2`` (fp32 and bf16
   parameters) and ``cp_shard 2 x tp 2`` against the one-process trainer,
   then ``tp 2`` at 2 layers under the host profiler;
12. expert parallelism — two child processes (``--ep-worker``) share the
   card over gloo under ``fsdp_ep_plan``, Qwen3-30B-A3B widths: each first
   runs the one-process trainer (1 layer, fp32, 2 rows of 2048 tokens, 2
   steps) and holds ``dp_shard 2, ep_shard 2`` and ``tp 2, ep_shard 2``
   (the tp ranks each dispatching half of the rows) to it, step by step
   and parameter piece by piece; then ``dp_shard 2, ep_shard 2`` at 2 of
   48 layers (bf16 compute, one row a rank): ms per step, the
   all-to-alls' host ms and bytes, readbacks, dropped pairs, rows
   received per layer call, B5 launches and peak memory per rank;
13. the example's mesh — 8 child processes share the card over gloo on
   ``example/qwen3_moe/pretrain.json``'s mesh at Qwen3-30B-A3B widths (1
   layer): fp32 legacy-flow steps against the one-process trainer, the HF
   export and its one-process reload, a timed bf16 step;
14. the example end to end — ``pretrain.json`` itself through the twin of
   ``example/qwen3_moe/pretrain.py`` (``d9d_tpu_torch/example``), its own
   launcher starting 8 ranks that share the card over gloo: all 40 steps
   with checkpoints at 20 and 40, the JSONL tracker and the export, into a
   temp directory; then ``save_40`` is deleted and the config launched
   again, and the resumed run's JSONL losses and export must equal the
   first run's bit for bit. Then Qwen3-30B-A3B widths at 1 layer through
   the twin in this process: 2 steps saving at 2, a resume to 4 that
   rotates ``save_2`` away, and 4 straight steps, whose parameters must
   equal the resumed run's bit for bit; the checkpoint's bytes, the save's
   blocking and waiting seconds, the restore and GB/s.

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


def _launches_per_call(e, calls):
    """A profiled kernel's launches per call: its record count over
    ``calls``, rounded to whole launches where it is at least one half (a
    kernel of every call; the profiler may have lost a record)."""
    launches = e.count / calls
    return round(launches) if launches >= 0.5 else launches


def _profile_kernels(fn, calls, activities=None):
    """``(profiler, CUDA kernel rows)`` of one window around ``fn()``
    (``calls`` calls). The window opens with a marker kernel
    (``torch.cuda._sleep``, left out of the rows), since the profiler can
    drop the record of a window's first kernel; a window in which some
    kernel's record count is not a whole number of launches a call is
    profiled again, up to three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        if all(e.count % calls == 0 for e in kernels):
            break
    return prof, kernels


def device_time(fn, kernel_tag, iters=20, warmup=3):
    """Device time per call of ``fn`` read from ``torch.profiler`` over
    ``iters`` calls: ``(ms of the kernels whose name holds ``kernel_tag``,
    ms of every kernel the calls launched, {kernel name: {"calls", "ms"}}
    per call)``.
    Unlike :func:`time_ms` it leaves out the host time of the wrapper
    between launches; null where the profiler recorded no device activity.
    The profiler can miss the record of the first launch in its window, so
    each window opens with a marker kernel (``torch.cuda._sleep``, left out
    of the reading); a kernel whose record count is still not a whole number
    of launches a call is profiled again, up to three windows. A kernel's
    ms per call is its mean time a recorded launch times its launches a
    call (the record count over ``iters``, rounded where it is at least one
    half), so a missed record does not lower it; ``calls`` is the record
    count over ``iters``, as read."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    _, kernels = _profile_kernels(calls, iters)
    if sum(e.self_device_time_total for e in kernels) <= 0:
        return None, None, None

    def ms_per_call(e):
        return (e.self_device_time_total / 1e3 / e.count
                * _launches_per_call(e, iters))

    per_call = {e.key[:72]: {"calls": e.count / iters, "ms": ms_per_call(e)}
                for e in kernels}
    own = sum(ms_per_call(e) for e in kernels if kernel_tag in e.key)
    return own, sum(ms_per_call(e) for e in kernels), per_call


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
        torch=torch.__version__, cuda=torch.version.cuda,
        compute_mode=compute_mode())
    return smi


def compute_mode():
    """The card's compute mode as nvidia-smi gives it: in an exclusive mode
    two processes cannot share the card (phase 9 needs them to)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    worst_d32 = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def compare(tag, dtype, b, t, hkv=hkv, hq=hq, d=d, **kw):
        q = _rand((b, t, hq, d), dtype, gen)
        k = _rand((b, t, hkv, d), dtype, gen)
        v = _rand((b, t, hkv, d), dtype, gen)
        sinks = kw.pop("sinks", None)
        o, lse = flash_attention(q, k, v, **kw)
        o2, lse2 = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(
                f"flash_fwd {tag} {dtype}: two runs on the same inputs differ")
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
        if d == 32:
            worst_d32[dtype] = max(worst_d32[dtype], err)
        cases.append({"case": tag, "dtype": str(dtype).split(".")[-1],
                      "shape": [b, t, hq, hkv, d], "max_abs_err": err,
                      "tolerance_use": use,
                      "lse_err": lerr, "two_runs_equal": True,
                      "ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                    iters=5, warmup=1)})
        return q, k, v

    def segs(b, t, pads):
        pad = torch.tensor(pads, device="cuda")[:, None]
        return (torch.arange(t, device="cuda")[None, :] >= pad).to(torch.int32)

    for dtype in (torch.bfloat16, torch.float32):
        qkv = compare("causal", dtype, 2, 2048)
        if dtype == torch.bfloat16:
            main_qkv = qkv
        # Qwen3-30B-A3B's GQA group: 32 query heads over 4 kv heads (g = 8)
        compare("causal_g8", dtype, 2, 2048, hkv=4)
        s = segs(2, 2048, [0, 700])
        compare("segments", dtype, 2, 2048, q_segments=s, kv_segments=s)
        compare("window", dtype, 2, 2048, window_size=512)
        compare("sinks", dtype, 2, 2048,
                sinks=torch.randn(hq, device="cuda", generator=gen))
        compare("t1000", dtype, 2, 1000)  # T not a multiple of any tile
        # head_dim 32 (example/qwen3_moe/pretrain.json): the example's
        # shape on each of its 8 ranks (2 rows, tp 2 leaves 4/2 heads), and
        # a long causal and a windowed case at its heads
        compare("d32_example", dtype, 2, 128, hq=4, hkv=2, d=32)
        compare("d32_causal", dtype, 2, 2048, hq=8, hkv=4, d=32)
        compare("d32_window_t1000", dtype, 2, 1000, hq=8, hkv=4, d=32,
                window_size=256)
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
    # the training paths' shape (bf16, B=2, T=2048, causal): one library call
    # with the causal flag, kv heads repeated
    qm, km, vm = main_qkv
    ms_main = time_ms(lambda: flash_attention(qm, km, vm), iters=20)
    qmh = qm.transpose(1, 2)
    kmh = km.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vmh = vm.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    library_ms_main = time_ms(lambda: F.scaled_dot_product_attention(
        qmh, kmh, vmh, is_causal=True), iters=20)
    # its least time: visible (row, key) pairs, 2 products of 2*D flops
    t_main = qm.shape[1]
    pairs_main = qm.shape[0] * hq * t_main * (t_main + 1) // 2
    flops_main = 4.0 * d * pairs_main
    bytes_main = (2 * qm.numel() + km.numel() + vm.numel()) * 2 \
        + qm.shape[0] * hq * t_main * 4
    bound_main = 1e3 * max(flops_main / H100_BF16_FLOPS,
                           bytes_main / H100_BYTES_PER_S)
    del qm, km, vm, qmh, kmh, vmh, main_qkv, qkv

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
        "max_abs_err_d32": worst_d32[torch.bfloat16],
        "max_abs_err_d32_fp32": worst_d32[torch.float32],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms, "library_max_abs_diff": lib_err,
        "ms_training_shape": ms_main,
        "bound_ms_training_shape": bound_main,
        "library_ms_training_shape": library_ms_main,
        "tflop_s_training_shape": flops_main / ms_main / 1e9,
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "timed_shape": {"B": 4, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
                        "dtype": "bfloat16", "segments": True},
        "training_shape": {"B": 2, "T": 2048, "Hq": hq, "Hkv": hkv, "D": d,
                           "dtype": "bfloat16", "causal": True,
                           "visible_pairs": pairs_main, "flops": flops_main,
                           "bytes": bytes_main},
        "bound_from": {"flops": flops, "bytes": nbytes},
        "library_ms_causal_b2_t2048": library_ms_main,
        "library_ms_causal_b2_t2048_is": "scaled_dot_product_attention, "
                                         "is_causal, kv heads repeated; the "
                                         "kernel's ms is case causal, bf16",
    }


# The decode kernels' own device time is read from the profiler over the
# kernels whose names hold this tag (the cores and the split combine of
# csrc/attn_*.cuh); the wrapper's other launches are reported beside it.
DECODE_KERNEL_TAG = "d9d::attn_"
# per-row write indices at the edges of 64-key tiles (0, 63, 64, 65), of a
# 1024-key span, and the cache's last slot (S - 1 = 4095)
DECODE_EDGE_STARTS = (0, 63, 64, 65, 1023, 1024, 2047, 4095)


DECODE_CLUSTER_SIZES = (1, 2, 4, 8)


def cluster_sweep(call):
    """Device ms per call of the cluster core at each cluster size, the
    wrapper's shape rule (``decode_cluster``) set aside for the reading."""
    from d9d_tpu_torch.ops.attention import decode

    rule = decode.decode_cluster
    out = {}
    try:
        for n in DECODE_CLUSTER_SIZES:
            decode.decode_cluster = lambda *a, n=n, **k: n
            out[str(n)] = device_time(call, DECODE_KERNEL_TAG, iters=50)[0]
    finally:
        decode.decode_cluster = rule
    return out


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
        o2, lse2 = flash_decode(q, kc, vc, start=start, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash_decode {tag} {dtype}: two runs differ")
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
                      "lse_err": lerr, "two_runs_equal": True,
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
    # starts at the edges of 64-key tiles and of the key split
    edges = torch.tensor(DECODE_EDGE_STARTS, device="cuda", dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        compare("step", dtype, 1, spread(1))
        compare("step_edges", dtype, 1, edges)
        # four new tokens a row: 16 rows a kv head, the cluster core's
        # contiguous route for T > 1
        compare("step_t4", dtype, 4, spread(4))
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

    def call():
        return flash_decode(q, kc, vc, start=start, kv_valid=valid)

    ms = time_ms(call, iters=50)
    dev_ms, dev_all_ms, per_call = device_time(call, DECODE_KERNEL_TAG,
                                               iters=50)
    sweep = cluster_sweep(call)
    # one 64-key tile a row: the launch, the first tile's trip and the merge
    one_tile = cluster_sweep(lambda: flash_decode(
        q, kc, vc, start=torch.full_like(start, 63)))
    # the batch rows at the decode profile's cache (1000 tokens): the
    # serving shape
    serving = cluster_sweep(lambda: flash_decode(
        q, kc, vc, start=torch.full_like(start, 999)))
    from d9d_tpu_torch.ops.attention.decode import cluster_capacity

    capacity = cluster_capacity(q.device, False, False, d)
    plain_ms = time_ms(
        lambda: flash_decode_plain(q, kc, vc, start=start, kv_valid=valid),
        iters=5)
    pos = torch.arange(s_len, device="cuda")[None, :]
    mask = ((pos <= start[:, None]) & valid)[:, None, None, :]
    qh = q.transpose(1, 2)
    o, _ = call()
    # the yardstick: one call on the kernel's own bytes (kv heads shared by
    # their query groups), and the earlier reading on a cache whose kv heads
    # were repeated g times beforehand (g times the bytes)
    kh = kc.repeat_interleave(hq // hkv, dim=1)
    vh = vc.repeat_interleave(hq // hkv, dim=1)
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = max_err(lib.transpose(1, 2), o)
    if not within_tolerance(lib.transpose(1, 2), o, torch.bfloat16):
        raise AssertionError(f"flash_decode vs library call: {lib_err}")
    library_ms_repeated = time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        iters=50)
    library_ms, gqa_note = library_ms_repeated, None
    try:
        lib = F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask,
                                             enable_gqa=True)
    except RuntimeError as exc:  # a yardstick only: say so and keep the old
        gqa_note = f"enable_gqa with a bool mask refused: {exc}"[:200]
    else:
        lib_err = max_err(lib.transpose(1, 2), o)
        if not within_tolerance(lib.transpose(1, 2), o, torch.bfloat16):
            raise AssertionError(f"flash_decode vs GQA library call: {lib_err}")
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(
                qh, kc, vc, attn_mask=mask, enable_gqa=True), iters=50)

    # kv_valid is read at its own width, over each row's visible keys only
    seen = float((start.cpu().to(torch.int64) + 1).sum())
    nbytes = (flash_decode_bytes(start, 1, b, hq, hkv, d, 2)
              + valid.element_size() * seen)
    flops = 4.0 * hq * d * seen
    by_ops, by_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/flash_decode.cu",
        "replaces": "d9d_tpu/ops/attention/pallas_decode.py:290",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms, "library_max_abs_diff": lib_err,
        "library_ms_repeated_kv": library_ms_repeated,
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "device_ms_all_kernels": dev_all_ms, "kernels_per_call": per_call,
        "cluster_sweep_device_ms": sweep,
        "one_tile_device_ms_by_cluster": one_tile,
        "cache_1000_device_ms_by_cluster": serving,
        "clusters_held_at_once": capacity,
        "library_call": ("scaled_dot_product_attention(enable_gqa=True)"
                         if gqa_note is None else gqa_note),
        "timed_shape": {"B": b, "T": 1, "Hq": hq, "Hkv": hkv, "S": s_len,
                        "D": d, "dtype": "bfloat16", "kv_valid": True,
                        "start": start.tolist()},
        "bound_from": {"flops": flops, "bytes": nbytes},
    }


# The paged decode kernel (B9) is held to the decode rule above, by the dtype
# of q and o. Its int8 pools add no term. The bf16 core (attn_decode_sm90.cuh)
# multiplies the int8 values as they are (exact in bf16) and places the
# scales per key: the k scale multiplies the key's fp32 score, which moves
# one fp32 rounding from each element of k to the score; the v scale
# multiplies p before p is rounded to bf16 for p.v, so the bf16 weights of
# p.v are p * v_scale with the same 2^-9 rounding the bf16 rule already
# allows for p. fp32 calls widen int8 * scale in one fp32 multiply, as the
# plain version does. The negative control reads one visible page of one
# row from the garbage page instead: that must break the rule many times over.
PAGED_LOST_PAGE_MIN_USE = 10.0


def _paged_pools(gen, dtype, quant, n_rows, n_pages, ps, hkv, d):
    """Random pools [P, Hkv, ps, D] (P = n_rows * n_pages + 1, page 0 the
    garbage page, random too) and a page table [n_rows, n_pages] that is
    shuffled (non-monotone) and shares row 0's first quarter of pages with
    row 3 (a prefix hit); int8 pools are quantized by the port's own rule."""
    from d9d_tpu_torch.nn.attention import _quantize_rows

    p_total = n_rows * n_pages + 1
    k = _rand((p_total, hkv, ps, d), dtype, gen)
    v = _rand((p_total, hkv, ps, d), dtype, gen)
    ks = vs = None
    if quant:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
    perm = torch.randperm(p_total - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(n_rows, n_pages).to(torch.int32)
    if n_rows > 3:
        table[3, : n_pages // 4] = table[0, : n_pages // 4]
    return k, v, ks, vs, table


def check_flash_decode_paged(gen):
    import torch.nn.functional as F

    from d9d_tpu_torch.ops.attention.decode import (
        flash_decode_bytes,
        flash_decode_paged,
        flash_decode_paged_plain,
        gather_pages_heads_major,
        gather_pages_heads_major_quant,
    )
    from d9d_tpu_torch.ops.attention.flash import apply_sinks

    b, hq, hkv, s_len, d = 8, 32, 8, 4096, 128
    cases = []
    worst = {}

    def spread(t):
        start = torch.linspace(0, s_len - t, b, device="cuda").to(torch.int32)
        start[0] = 2048  # no row at slot 0: every row sees a few pages
        return start

    def compare(tag, dtype, quant, t, ps, start, window=None, sinks=None):
        q = _rand((b, t, hq, d), dtype, gen)
        k, v, ks, vs, table = _paged_pools(gen, dtype, quant, b,
                                           s_len // ps, ps, hkv, d)
        kw = dict(start=start, page_table=table, k_scale=ks, v_scale=vs,
                  window_size=window)
        o, lse = flash_decode_paged(q, k, v, **kw)
        o2, lse2 = flash_decode_paged(q, k, v, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(
                f"flash_decode_paged {tag} {dtype} int8={quant}: two runs "
                f"differ")
        op, lsep = flash_decode_paged_plain(q, k, v, **kw)
        if sinks is not None:
            o, lse = apply_sinks(o, lse, sinks)
            op, lsep = apply_sinks(op, lsep, sinks)
        err, lerr = max_err(o, op), max_err(lse, lsep)
        use = tolerance_use(o, op, dtype)
        if not (torch.isfinite(o.float()).all() and use <= 1.0
                and lerr <= LSE_TOL):
            raise AssertionError(
                f"flash_decode_paged {tag} {dtype} int8={quant}: max_abs_err "
                f"{err} uses {use} of its tolerance, lse err {lerr} (limit "
                f"{LSE_TOL})")
        pools = "int8" if quant else str(dtype).split(".")[-1]
        worst[pools] = max(worst.get(pools, 0.0), err)
        cases.append({"case": tag, "dtype": str(dtype).split(".")[-1],
                      "pools": pools, "page_size": ps,
                      "shape": [b, t, hq, hkv, s_len, d], "max_abs_err": err,
                      "tolerance_use": use, "lse_err": lerr,
                      "two_runs_equal": True})
        return q, k, v, ks, vs, table, o

    lost = {}
    for dtype in (torch.bfloat16, torch.float32):
        for quant in (False, True):
            compare("step_ps16", dtype, quant, 1, 16, spread(1))
            compare("step_ps8", dtype, quant, 1, 8, spread(1))
            compare("step_ps4", dtype, quant, 1, 4, spread(1))
            edges = torch.tensor(DECODE_EDGE_STARTS, device="cuda",
                                 dtype=torch.int32)
            compare("step_edges_ps16", dtype, quant, 1, 16, edges)
            compare("step_edges_ps4", dtype, quant, 1, 4, edges)
            compare("window1024", dtype, quant, 1, 16, spread(1),
                    window=1024)
            compare("chunk4_sinks", dtype, quant, 4, 16, spread(4),
                    sinks=torch.randn(hq, device="cuda", generator=gen))
            # negative control: row 0 reads one of its visible pages from
            # the garbage page in the plain version
            start = spread(1)
            q, k, v, ks, vs, table, o = compare(
                "lost_page_base", dtype, quant, 1, 16, start)
            bad = table.clone()
            bad[0, 5] = 0
            op, _ = flash_decode_paged_plain(
                q, k, v, start=start, page_table=bad, k_scale=ks, v_scale=vs)
            use = tolerance_use(o, op, dtype)
            pools = "int8" if quant else str(dtype).split(".")[-1]
            lost[f"{str(dtype).split('.')[-1]}_{pools}"] = use
            if use < PAGED_LOST_PAGE_MIN_USE:
                raise AssertionError(
                    f"flash_decode_paged lost-page control {dtype} "
                    f"int8={quant}: uses only {use} of the tolerance")

    # timed: the serving path's call, bf16 and int8 pools of page 16
    timed = {}
    for quant in (False, True):
        start = spread(1)
        q, k, v, ks, vs, table, _ = compare(
            "step_timed", torch.bfloat16, quant, 1, 16, start)
        kw = dict(start=start, page_table=table, k_scale=ks, v_scale=vs)
        ms = time_ms(lambda: flash_decode_paged(q, k, v, **kw), iters=50)
        dev_ms, dev_all_ms, per_call = device_time(
            lambda: flash_decode_paged(q, k, v, **kw), DECODE_KERNEL_TAG,
            iters=50)
        sweep = cluster_sweep(lambda: flash_decode_paged(q, k, v, **kw))
        plain_ms = time_ms(lambda: flash_decode_paged_plain(q, k, v, **kw),
                           iters=5)
        pos = torch.arange(s_len, device="cuda")[None, :]
        mask = (pos <= start[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        g = hq // hkv

        def chain():
            if quant:
                kc = gather_pages_heads_major_quant(k, ks, table, q.dtype)
                vc = gather_pages_heads_major_quant(v, vs, table, q.dtype)
            else:
                kc = gather_pages_heads_major(k, table)
                vc = gather_pages_heads_major(v, table)
            return F.scaled_dot_product_attention(
                qh, kc.repeat_interleave(g, dim=1),
                vc.repeat_interleave(g, dim=1), attn_mask=mask)

        o, _ = flash_decode_paged(q, k, v, **kw)
        chain_err = max_err(chain().transpose(1, 2), o)
        chain_ms = time_ms(chain, iters=20)
        nbytes = flash_decode_bytes(
            start, 1, b, hq, hkv, d, 2, page_size=16, n_pages=s_len // 16,
            kv_itemsize=1 if quant else 2, quant=quant) + b * 4
        flops = 4.0 * hq * d * float((start.cpu().to(torch.int64) + 1).sum())
        timed["int8" if quant else "bfloat16"] = {
            "ms": ms, "device_ms": dev_ms,
            "device_ms_all_kernels": dev_all_ms, "kernels_per_call": per_call,
            "cluster_sweep_device_ms": sweep,
            "plain_ms": plain_ms, "library_chain_ms": chain_ms,
            "library_chain_max_abs_diff": chain_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(flops / H100_BF16_FLOPS,
                                  nbytes / H100_BYTES_PER_S),
        }
    main = timed["bfloat16"]
    by_ops = main["flops"] / H100_BF16_FLOPS
    by_bytes = main["bytes"] / H100_BYTES_PER_S
    return {
        "name": "flash_decode_paged", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/flash_decode.cu",
        "replaces": "d9d_tpu/ops/attention/pallas_decode.py:252",
        "max_abs_err": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "max_abs_err_int8": worst["int8"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": None,
        "library_chain_ms": main["library_chain_ms"],
        "ms_int8": timed["int8"]["ms"],
        "device_ms_int8": timed["int8"]["device_ms"],
        "bound_ms_int8": timed["int8"]["bound_ms"],
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "int8_rule": ("the rule of q's dtype; int8 pools add no term (k "
                      "scale on the score, v scale on p before its bf16 "
                      "rounding)"),
        "lost_page_tolerance_use": lost,
        "lost_page_min_use": PAGED_LOST_PAGE_MIN_USE,
        "timed": timed,
        "timed_shape": {"B": b, "T": 1, "Hq": hq, "Hkv": hkv, "S": s_len,
                        "D": d, "page_size": 16, "dtype": "bfloat16",
                        "pools": ["bfloat16", "int8"]},
        "library_chain": ("gather pages (int8: times scales, to bf16) + "
                          "repeat_interleave + scaled_dot_product_attention"),
    }


# Tolerances of the backward kernels vs their plain version, same inputs.
# Same rule as above, other constants. The plain version multiplies the
# inputs in exact fp32, sums in fp32 and rounds each result to the output
# dtype once; every kernel sums its products in fp32 too.
# fp32 (all three kernels) multiply in exact fp32 on the CUDA cores, so
# kernel and plain version differ in the order of sums only (the fused dq
# in its fixed order of key tiles).
# The fused kernel in bf16 runs on the tensor cores (first products of the
# bf16 inputs, exact, summed in fp32) and carries p and ds into the second
# products as a hi/lo pair of bf16 values: each term is then off by about
# 2^-18 of itself, not 2^-9, so it keeps the row term of exact products,
# 2^-12 of the row's size (BWD_RULE["fused"]; the emulation in
# tests/test_torch_flash_fused_mma.py uses a fraction of it, and one
# rounding instead of the pair breaks it). In bf16 two fp32 values that
# close may still round to neighbouring bf16 values: one bf16 step, 2^-7
# of the element (RTOL). Its absolute term is the split kernels' 2^-17, for
# the reason given below: dp = do.v summed on the tensor cores, on rows
# whose gradient cancels.
# bf16 dq and dk/dv (the tensor-core kernels) round p and ds to bf16 before
# the second products (dv = p^T.do, dk = ds^T.q, dq = ds.k), as the forward
# rounds p before p.v (ROW_RTOL above): each term of those sums is off by up
# to 2^-9 of itself, with signs that do not line up, so the sum is off by
# about 2^-9 of the root of the sum of squared terms. That size is the row's
# and not the element's, and for dq and dk it is not even the result's: the
# terms of ds cancel (sum_k p (dp - delta) = 0 in each row), so a gradient
# element near 0 carries the error of terms of the row's size. Hence a row
# term, 2^-7 of the row's largest element: 4 units of one rounding. The
# designed arithmetic, emulated in plain PyTorch against the plain version
# (tests/test_torch_flash_bwd_mma.py: causal, window, segments, shifts,
# g = 2 and 8), uses at most about half of it; a lost 64-key tile (dq) or a
# lost 64-row tile of one query head (dk, dv) costs a few percent of the
# row and breaks it many times over — the negative controls below emulate
# both with the plain version and must break the rule of the split kernels,
# and the fused kernel's rule by more than FUSED_CONTROL_MIN_USE.
# These kernels also sum dp = do.v in another order than the plain version
# (the tensor cores' k-steps), and where a row's gradient cancels to 0 only
# that fp32 rounding is left: the first row under causal masking sees one
# key, where dp = delta exactly. Each side's dp - delta is then off by about
# 2^-24 of sum_d |do_d v_d| (~81 for standard-normal inputs at D = 128),
# times scale (0.088) and |k| (up to ~4): ~1.7e-6, and ~3.4e-6 between two
# orders of summation. The absolute term is twice that, 2^-17 (7.6e-6).
BWD_RULE = {  # (atol, rtol, row_rtol)
    "split": {torch.float32: (1e-4, 1e-4, 0.0),
              torch.bfloat16: (2.0 ** -17, 2.0 ** -7, 2.0 ** -7)},
    "fused": {torch.float32: (1e-4, 1e-4, 0.0),
              torch.bfloat16: (2.0 ** -17, 2.0 ** -7, 2.0 ** -12)},
}
FUSED_CONTROL_MIN_USE = 10.0  # the lost-tile controls under the fused rule
BWD_TOLERANCE = {
    "bf16": list(BWD_RULE["split"][torch.bfloat16]),
    "bf16_fused": list(BWD_RULE["fused"][torch.bfloat16]),
    "fp32": list(BWD_RULE["split"][torch.float32]),
    "rule": TOLERANCE["rule"],
}
H100_FP32_FLOPS = 67e12  # CUDA-core fp32 peak (exact fp32 products)


def bwd_tolerance_use(got, want, dtype, fused=False):
    """tolerance_use under the backward rule of the split kernels (dq,
    dk/dv) or, with fused=True, of the fused kernel."""
    want = want.float()
    atol, rtol, row = BWD_RULE["fused" if fused else "split"][dtype]
    allowed = (atol + rtol * want.abs()
               + row * want.abs().amax(dim=-1, keepdim=True))
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


def _lost_tile_controls(q, k, v, do, o, lse, delta, want, dtype,
                        fused=False):
    """tolerance_use of the plain backward with one tile's contribution
    removed, against the full plain backward: keys 0..63 dropped from every
    dq row, and the last 64 query rows of head 0 dropped from dk and dv.
    Causal; under the split rule, or with fused=True the fused one; must
    exceed 1."""
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
    return {"dq_without_key_tile_0":
                bwd_tolerance_use(dq_lost, want[0], dtype, fused),
            "dk_without_last_row_tile_of_head_0":
                bwd_tolerance_use(dk_l, want[1], dtype, fused),
            "dv_without_last_row_tile_of_head_0":
                bwd_tolerance_use(dv_l, want[2], dtype, fused)}


def _sdpa_bwd_library_ms(q, k, v, do, want_dq):
    """The library yardstick of the backward: one scaled_dot_product_attention
    call at the same shape, causal, kv heads repeated beforehand; timed as
    (forward + backward) - forward, 10 calls each. Returns (ms, max abs diff
    of its dq from the plain version's)."""
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
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
    err = max_err(qh.grad.transpose(1, 2), want_dq)
    return time_ms(lib_fwd_bwd, iters=10) - time_ms(lib_fwd, iters=10), err


def check_flash_bwd(gen):
    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    hq, hkv, d = 32, 8, 128
    cases = []
    worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
             for n in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")}
    worst_use = {n: 0.0 for n in worst}
    worst_d32 = {n: {torch.float32: 0.0, torch.bfloat16: 0.0} for n in worst}
    repeats = [0]  # cases whose two fused runs were compared bit for bit

    def segs(b, t, pads):
        pad = torch.tensor(pads, device="cuda")[:, None]
        return (torch.arange(t, device="cuda")[None, :] >= pad).to(torch.int32)

    def compare(tag, dtype, b, t, hq_=hq, hkv_=hkv, d_=d, **kw):
        q, k, v, do, o, lse, delta = _bwd_inputs(gen, dtype, b, t, hq_, hkv_,
                                                 d_, **kw)
        want = flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
        split = flash_attention_bwd(q, k, v, do, lse, delta, **kw)
        fused = flash_attention_bwd(q, k, v, do, lse, delta, fused=True, **kw)
        # the fused dq is summed in a fixed order: a second run on the same
        # inputs gives the same bits (dk and dv have no cross-block sums)
        again = flash_attention_bwd(q, k, v, do, lse, delta, fused=True, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(fused, again)):
            raise AssertionError(
                f"flash_bwd_fused {tag} {dtype}: two runs differ by "
                f"{[max_err(a, b_) for a, b_ in zip(fused, again)]}")
        repeats[0] += 1
        del again
        row = {"case": tag, "dtype": str(dtype).split(".")[-1],
               "shape": [b, t, hq_, hkv_, d_], "fused_repeat_equal": True}
        for name, got, which in (("flash_bwd_dq", split, (0,)),
                                 ("flash_bwd_dkv", split, (1, 2)),
                                 ("flash_bwd_fused", fused, (0, 1, 2))):
            errs = [max_err(got[i], want[i]) for i in which]
            uses = [bwd_tolerance_use(got[i], want[i], dtype,
                                      fused=name == "flash_bwd_fused")
                    for i in which]
            finite = all(bool(torch.isfinite(got[i].float()).all())
                         for i in which)
            if not finite or max(uses) > 1.0:
                raise AssertionError(
                    f"{name} {tag} {dtype}: max_abs_err {errs} uses {uses} "
                    f"of its tolerance (finite: {finite})")
            worst[name][dtype] = max(worst[name][dtype], max(errs))
            if d_ == 32:
                worst_d32[name][dtype] = max(worst_d32[name][dtype],
                                             max(errs))
            worst_use[name] = max(worst_use[name], max(uses))
            row[name] = {"max_abs_err": max(errs), "tolerance_use": max(uses)}
        pairs, work = _bwd_work(q, k, kw, dtype)
        ms = _time_bwd_kernels(q, k, v, do, lse, delta, kw)
        for name in work:
            row[name].update(ms=ms[name], bound_ms=work[name]["bound_ms"],
                             bound_by=work[name]["bound_by"],
                             tflop_s=work[name]["flops"] / ms[name] / 1e9)
        row["visible_pairs"] = pairs
        cases.append(row)
        return (q, k, v, do, o, lse, delta), want, work, ms

    for dtype in (torch.bfloat16, torch.float32):
        compare("causal", dtype, 2, 2048)
        # Qwen3-30B-A3B's GQA group: 32 query heads over 4 kv heads (g = 8)
        g8 = compare("causal_g8", dtype, 2, 2048, hkv_=4)
        if dtype == torch.bfloat16:
            g8_bf16 = g8
        compare("window512", dtype, 2, 2048, window_size=512)
        s = segs(2, 2048, [0, 700])
        compare("segments_padding", dtype, 2, 2048, q_segments=s, kv_segments=s)
        compare("t1000", dtype, 2, 1000)
        compare("d64", dtype, 2, 2048, d_=64)
        # head_dim 32 (example/qwen3_moe/pretrain.json): each of its 8
        # ranks' shape, and a long causal and a windowed case at its heads
        compare("d32_example", dtype, 2, 128, hq_=4, hkv_=2, d_=32)
        compare("d32_causal", dtype, 2, 2048, hq_=8, hkv_=4, d_=32)
        compare("d32_window_t1000", dtype, 2, 1000, hq_=8, hkv_=4, d_=32,
                window_size=256)
        # non-causal, query segments that match no key at a few positions:
        # those rows see no key (forward zeros, lse = -1e30) and the
        # ungated backward gives them p = 1 on every key, as the TPU
        # kernels do; without causal or window every kernel visits every
        # key, so all three see there the keys the plain version sees
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
    fused_controls = _lost_tile_controls(q, k, v, do, o, lse, delta, want,
                                         torch.bfloat16, fused=True)
    if min(fused_controls.values()) <= FUSED_CONTROL_MIN_USE:
        raise AssertionError(
            f"a lost tile misses the fused bf16 rule by no more than "
            f"{FUSED_CONTROL_MIN_USE}x: {fused_controls}")
    plain_ms = time_ms(
        lambda: flash_attention_bwd_plain(q, k, v, do, lse, delta), iters=3,
        warmup=1)
    split_ms = time_ms(lambda: flash_attention_bwd(q, k, v, do, lse, delta),
                       iters=5, warmup=1)
    fused_wrapper_ms = time_ms(
        lambda: flash_attention_bwd(q, k, v, do, lse, delta, fused=True),
        iters=5, warmup=1)
    library_ms, lib_err = _sdpa_bwd_library_ms(q, k, v, do, want[0])
    (q8, k8, v8, do8, *_), want8, _, _ = g8_bf16
    library_ms_g8, _ = _sdpa_bwd_library_ms(q8, k8, v8, do8, want8[0])
    del q8, k8, v8, do8, want8, g8, g8_bf16
    kernels = []
    for name, src_line in (("flash_bwd_dq", 583), ("flash_bwd_dkv", 602),
                           ("flash_bwd_fused", 548)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "d9d_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"d9d_tpu/ops/attention/pallas_flash.py:{src_line}",
            "max_abs_err": worst[name][torch.bfloat16],
            "max_abs_err_fp32": worst[name][torch.float32],
            "max_abs_err_d32": worst_d32[name][torch.bfloat16],
            "max_abs_err_d32_fp32": worst_d32[name][torch.float32],
            "tolerance_use": worst_use[name],
            "ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": work[name]["bound_ms"],
            "bound_by": work[name]["bound_by"],
            "library_ms": library_ms,
            "tflop_s": work[name]["flops"] / ms[name] / 1e9,
        })
    return kernels, {
        "cases": cases, "tolerance": BWD_TOLERANCE,
        "negative_controls": controls,
        "negative_controls_rule": "bf16, dq and dk/dv (BWD_RULE['split'])",
        "negative_controls_fused_rule": fused_controls,
        "fused_repeat_bitwise_equal_cases": repeats[0],
        "library_ms_g8": library_ms_g8,
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


# ---------------------------------------------------------------------------
# B4: the flash kernels at global offsets (the ring-attention block)
#
# Held to the same rules as B1 (forward) and B2/B3 (backward), by dtype, on
# the query rows that see at least one key of the block. Rows that see none
# (the whole block in the causal future, a window that ends before the
# block, a segment absent from the key chunk) must come out as o = 0 and
# lse <= -1e29 on both sides. The backward takes its cotangents from a
# downstream combine_attention_chunks with a finite partner chunk and a
# nonzero cotangent on the merged lse, as ring attention gives them: a row
# without a key then has a zero cotangent, and its gradients are zero on
# both sides whatever key tiles the kernels visit (ROADMAP C3).
BLOCK_T = 4096         # chunk length of the kernel checks
MAIN_T_LOC = 8192      # phase 9's chunk length (16384 tokens over 2 ranks)
BLOCK_COMPOSE_T = 16384
BLOCK_MISS_MIN_USE = 10.0  # the offsets-zeroed control must miss by this


def _block_cotangents(o, lse, gen):
    """(do in o's dtype, dlse) of a downstream combine with a partner chunk
    whose lse is of the block's size, and random cotangents on the merged
    output and lse."""
    from d9d_tpu_torch.ops.attention.flash import combine_attention_chunks

    po = torch.randn(o.shape, device="cuda", generator=gen)
    plse = 8.0 + torch.randn(lse.shape, device="cuda", generator=gen)
    g_out = torch.randn(o.shape, device="cuda", generator=gen)
    g_lse = torch.randn(lse.shape, device="cuda", generator=gen)
    with torch.enable_grad():
        o_ = o.detach().float().requires_grad_()
        l_ = lse.detach().clone().requires_grad_()
        out, merged = combine_attention_chunks(po, plse, o_, l_)
        loss = (out * g_out).sum() + (merged * g_lse).sum()
        do, dlse = torch.autograd.grad(loss, (o_, l_))
    return do.to(o.dtype).contiguous(), dlse


def _block_plain_fwd(q, k, v, **kw):
    """The plain forward one kv head at a time (same function; the
    [T, T] fp32 logits of all heads at once would not fit beside the
    rest)."""
    from d9d_tpu_torch.ops.attention.flash import flash_attention_plain

    hkv = k.shape[2]
    g = q.shape[2] // hkv
    parts = [flash_attention_plain(q[:, :, h * g:(h + 1) * g],
                                   k[:, :, h:h + 1], v[:, :, h:h + 1], **kw)
             for h in range(hkv)]
    return (torch.cat([p[0] for p in parts], dim=2),
            torch.cat([p[1] for p in parts], dim=1))


def _block_plain_bwd(q, k, v, do, lse, delta, **kw):
    """The plain backward one kv head at a time (same function), for the
    same reason as _block_plain_fwd."""
    from d9d_tpu_torch.ops.attention.flash import flash_attention_bwd_plain

    hkv = k.shape[2]
    g = q.shape[2] // hkv
    parts = [flash_attention_bwd_plain(
        q[:, :, h * g:(h + 1) * g], k[:, :, h:h + 1], v[:, :, h:h + 1],
        do[:, :, h * g:(h + 1) * g], lse[:, h * g:(h + 1) * g],
        delta[:, h * g:(h + 1) * g], **kw) for h in range(hkv)]
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


def _block_work(t, hq, d, kw, segs=None):
    """Visible (query, key) pairs of the block and the least times: forward
    2 products, dq 3, dk/dv 4 (2*D flops each per pair) at the bf16 peak."""
    from d9d_tpu_torch.ops.attention.flash import _mask

    mask = _mask(t, t, "cuda", kw.get("causal", True), kw.get("window_size"),
                 *(segs or (None, None)), kw["q_offset"], kw["k_offset"])
    pairs = float(mask.sum()) * hq
    ms = {name: 1e3 * products * 2.0 * d * pairs / H100_BF16_FLOPS
          for name, products in (("fwd", 2), ("dq", 3), ("dkv", 4))}
    return pairs, ms


def _efficient_attention(q, k, v, causal):
    """The library yardstick of a block: one call that returns o and its
    lse, kv heads repeated for the group, [B, H, T, D] layout."""
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qh, kh, vh, None, True, 0.0, causal, scale=q.shape[-1] ** -0.5)


def _efficient_attention_bwd_ms(q, k, v, do, causal):
    """The library yardstick of a block's backward: the same call with
    autograd, timed as (forward + backward) - forward."""
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_()
    doh = do.transpose(1, 2)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, None, True, 0.0, causal, scale=q.shape[-1] ** -0.5)

    def fwd():
        with torch.no_grad():
            call()

    def fwd_bwd():
        call()[0].backward(doh)

    return time_ms(fwd_bwd, iters=3, warmup=1) - time_ms(fwd, iters=3, warmup=1)


# the blocks one library call computes: no offsets, so only a causal block on
# the diagonal and a block every query sees whole
BLOCK_LIBRARY_CASES = {"diagonal": True, "past": False,
                       "non_causal_negative_shift": False}


def check_flash_block(gen):
    from d9d_tpu_torch.ops.attention import flash as F

    hq, hkv, d, t = 32, 8, 128, BLOCK_T
    # global packed-sequence ids over two chunks: segments [0, 3000),
    # [3000, 6000), [6000, 8192); the query chunk is the second one, so its
    # rows of the last segment see no key of the first chunk
    pos = torch.arange(2 * t, device="cuda")
    ids = ((pos >= 3000).int() + (pos >= 6000).int())[None]
    seg = (ids[:, t:].contiguous(), ids[:, :t].contiguous())
    specs = [
        ("diagonal", dict(q_offset=0, k_offset=0), None),
        ("past", dict(q_offset=t, k_offset=0), None),
        ("future", dict(q_offset=0, k_offset=t), None),
        ("window1536_straddling",
         dict(q_offset=t, k_offset=0, window_size=1536), None),
        ("segments", dict(q_offset=t, k_offset=0), seg),
        ("non_causal_negative_shift",
         dict(q_offset=0, k_offset=t, causal=False), None),
    ]
    cases, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_use = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for tag, kw, segs in specs:
            q = _rand((1, t, hq, d), dtype, gen)
            k = _rand((1, t, hkv, d), dtype, gen)
            v = _rand((1, t, hkv, d), dtype, gen)
            skw = dict(kw)
            if segs is not None:
                skw.update(q_segments=segs[0], kv_segments=segs[1])
            o, lse = F.flash_attention(q, k, v, **skw)
            torch.cuda.synchronize()
            op, lsep = F.flash_attention_plain(q, k, v, **skw)
            vis = F._mask(t, t, "cuda", kw.get("causal", True),
                          kw.get("window_size"), *(segs or (None, None)),
                          kw["q_offset"], kw["k_offset"])
            rows = vis.expand(1, 1, 1, t, t).any(-1)[:, 0, 0]  # [B, T]
            dead = int((~rows).sum())
            row = {"case": tag, "dtype": str(dtype).split(".")[-1],
                   "shape": [1, t, hq, hkv, d],
                   "offsets": [kw["q_offset"], kw["k_offset"]],
                   "rows_without_a_key": dead}
            if rows.any():
                use = tolerance_use(o[rows], op[rows], dtype)
                lerr = max_err(lse.transpose(1, 2)[rows],
                               lsep.transpose(1, 2)[rows])
                err = max_err(o[rows], op[rows])
            else:
                use = lerr = err = 0.0
            dead_ok = bool((o[~rows] == 0).all()) and bool(
                (lse.transpose(1, 2)[~rows] <= -1e29).all()) and bool(
                (lsep.transpose(1, 2)[~rows] <= -1e29).all())
            if not (torch.isfinite(o.float()).all() and use <= 1.0
                    and lerr <= LSE_TOL and dead_ok):
                raise AssertionError(
                    f"flash_block fwd {tag} {dtype}: uses {use} of its "
                    f"tolerance, lse err {lerr}, rows without a key zero "
                    f"with lse at the sentinel: {dead_ok}")
            do, dlse = _block_cotangents(o, lse, gen)
            delta = F.block_delta(do, o, dlse)
            want = F.flash_attention_bwd_plain(q, k, v, do, lse, delta, **skw)
            split = F.flash_attention_bwd(q, k, v, do, lse, delta, **skw)
            fused = F.flash_attention_bwd(q, k, v, do, lse, delta,
                                          fused=True, **skw)
            torch.cuda.synchronize()
            uses = {}
            for name, got in (("split", split), ("fused", fused)):
                for i, label in enumerate(("dq", "dk", "dv")):
                    if not torch.isfinite(got[i].float()).all():
                        raise AssertionError(
                            f"flash_block {tag} {dtype} {name} {label} "
                            f"not finite")
                    uses[f"{name}_{label}"] = bwd_tolerance_use(
                        got[i], want[i], dtype, fused=name == "fused")
                    worst[dtype] = max(worst[dtype], max_err(got[i], want[i]))
            if max(uses.values()) > 1.0:
                raise AssertionError(
                    f"flash_block bwd {tag} {dtype}: tolerance use {uses}")
            if tag == "future" and not all(
                    bool((x == 0).all()) for x in (*split, *fused)):
                raise AssertionError("flash_block future: nonzero gradients")
            worst[dtype] = max(worst[dtype], err)
            worst_use = max(worst_use, use, *uses.values())
            row.update(max_abs_err=err, tolerance_use=use, lse_err=lerr,
                       bwd_tolerance_use=uses)
            if dtype == torch.bfloat16:
                pairs, bound = _block_work(t, hq, d, kw, segs)
                shift = kw["q_offset"] - kw["k_offset"]
                row["visible_pairs"] = pairs
                row["fwd_ms"] = time_ms(
                    lambda: F.flash_attention(q, k, v, **skw), iters=3,
                    warmup=1)
                row["bwd_ms"] = _time_block_bwd(q, k, v, do, lse, delta,
                                                skw, shift)
                row["bound_ms"] = bound
                row["library_ms"] = None
                if tag in BLOCK_LIBRARY_CASES:
                    row["library_ms"] = time_ms(_efficient_attention(
                        q, k, v, BLOCK_LIBRARY_CASES[tag]), iters=3, warmup=1)
            cases.append(row)
            del q, k, v, o, lse, op, lsep, do, dlse, delta, want, split, fused
        torch.cuda.empty_cache()

    compose = _block_composition(gen)

    # the main path's chunk (T_loc 8192), bf16: the diagonal block every rank
    # attends and the full past block rank 1 attends, forward and split
    # backward (the kernels phase 9 runs) held against the plain versions per
    # kv head; then the past block is timed
    t = MAIN_T_LOC
    main_checks = []
    for tag, kw in (("diagonal", dict(q_offset=0, k_offset=0)),
                    ("past", dict(q_offset=t, k_offset=0))):
        q = _rand((1, t, hq, d), torch.bfloat16, gen)
        k = _rand((1, t, hkv, d), torch.bfloat16, gen)
        v = _rand((1, t, hkv, d), torch.bfloat16, gen)
        o, lse = F.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        op, lsep = _block_plain_fwd(q, k, v, **kw)
        use = tolerance_use(o, op, torch.bfloat16)
        lerr = max_err(lse, lsep)
        err = max_err(o, op)
        del op, lsep
        do, dlse = _block_cotangents(o, lse, gen)
        delta = F.block_delta(do, o, dlse)
        got = F.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        want = _block_plain_bwd(q, k, v, do, lse, delta, **kw)
        finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
        uses = {label: bwd_tolerance_use(a, b, torch.bfloat16)
                for label, a, b in zip(("dq", "dk", "dv"), got, want)}
        errs = {label: max_err(a, b)
                for label, a, b in zip(("dq", "dk", "dv"), got, want)}
        if not (finite and use <= 1.0 and lerr <= LSE_TOL
                and max(uses.values()) <= 1.0):
            raise AssertionError(
                f"flash_block T_loc {t} {tag}: forward uses {use}, lse err "
                f"{lerr}; split backward finite {finite}, uses {uses}")
        worst[torch.bfloat16] = max(worst[torch.bfloat16], err,
                                    *errs.values())
        worst_use = max(worst_use, use, *uses.values())
        main_checks.append({"case": tag, "offsets": [kw["q_offset"],
                                                     kw["k_offset"]],
                            "tolerance_use": use, "lse_err": lerr,
                            "max_abs_err": err, "bwd_split_tolerance_use": uses,
                            "bwd_split_max_abs_err": errs})
        del got, want
        if tag == "diagonal":
            del q, k, v, o, lse, do, dlse, delta
        torch.cuda.empty_cache()
    ms = time_ms(lambda: F.flash_attention(q, k, v, **kw), iters=5, warmup=1)
    plain_ms = time_ms(lambda: _block_plain_fwd(q, k, v, **kw), iters=2,
                       warmup=1)
    bwd_ms = _time_block_bwd(q, k, v, do, lse, delta, kw, t)
    pairs, bound = _block_work(t, hq, d, kw)
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + hq * t * 4
    # yardstick: one library call with its lse, the same non-causal block
    lib = _efficient_attention(q, k, v, False)
    lib_err = max_err(lib()[0].transpose(1, 2), o)
    library_ms = time_ms(lib, iters=5, warmup=1)
    library_bwd_ms = _efficient_attention_bwd_ms(q, k, v, do, False)
    del q, k, v, o, lse, do, dlse, delta, lib
    torch.cuda.empty_cache()
    by_ops = bound["fwd"] / 1e3
    by_bytes = nbytes / H100_BYTES_PER_S
    return {
        "name": "flash_block", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/flash_fwd.cu",
        "backward_source": "d9d_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "d9d_tpu/ops/attention/pallas_flash.py:709",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "tolerance_use": worst_use,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms,
        "bwd_split_ms": bwd_ms["dq"] + bwd_ms["dkv"],
        "bwd_bound_ms": bound["dq"] + bound["dkv"],
        "bwd_library_ms": library_bwd_ms,
    }, {
        "cases": cases, "tolerance": TOLERANCE,
        "bwd_tolerance": BWD_TOLERANCE,
        "composition": compose, "main_shape_checks": main_checks,
        "timed_shape": {"B": 1, "T_loc": t, "Hq": hq, "Hkv": hkv, "D": d,
                        "dtype": "bfloat16", "q_offset": t, "k_offset": 0,
                        "causal": True, "visible_pairs": pairs},
        "timed_ms_is": "the B4 forward kernel; bwd_ms the backward kernels "
                       "alone at the same offsets",
        "timed_bwd_ms": bwd_ms, "timed_bound_ms": bound,
        "plain_ms_is": "the plain forward, one kv head at a time",
        "library_ms_is": "_scaled_dot_product_efficient_attention with its "
                         "lse, the same non-causal block, kv heads repeated; "
                         "null in a case where no single call takes the "
                         "block's offsets (future, window, segments)",
        "library_max_abs_diff": lib_err,
        "bwd_library_ms_is": "the same call with autograd, forward+backward "
                             "minus forward, the same non-causal block",
    }


def _time_block_bwd(q, k, v, do, lse, delta, kw, shift):
    """ms of each backward kernel alone at the block's shift (the fused one
    into a preallocated fp32 dq)."""
    from d9d_tpu_torch.ops.attention import flash as F

    d = q.shape[-1]
    qs, ks = kw.get("q_segments"), kw.get("kv_segments")
    dq = torch.empty_like(q)
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = 0 if q.dtype == torch.float32 else 1

    def launch(kernel):
        F._launch_bwd(kernel, q, k, v, do, lse, delta, qs, ks,
                      dq32 if kernel == 2 else dq, dk, dv, code, d ** -0.5,
                      kw.get("causal", True), kw.get("window_size"), shift)

    return {name: time_ms(lambda n=n: launch(n), iters=3, warmup=1)
            for name, n in (("dq", 0), ("dkv", 1), ("fused", 2))}


def _block_composition(gen):
    """Causal attention over BLOCK_COMPOSE_T tokens as 4 chunks through
    flash_attention_block + combine_attention_chunks (autograd through
    FlashBlockFunction) against the whole-sequence flash kernels (B1/B2),
    forward and grads, fp32; then the same chunks with both offsets forced
    to 0, which must miss by BLOCK_MISS_MIN_USE times the rule."""
    from d9d_tpu_torch.ops.attention import flash as F

    hq, hkv, d, n = 32, 8, 128, 4
    t = BLOCK_COMPOSE_T
    tl = t // n
    dtype = torch.float32
    q = _rand((1, t, hq, d), dtype, gen).requires_grad_()
    k = _rand((1, t, hkv, d), dtype, gen).requires_grad_()
    v = _rand((1, t, hkv, d), dtype, gen).requires_grad_()
    do = _rand((1, t, hq, d), dtype, gen)

    def chunked(zero_offsets):
        outs = []
        for i in range(n):
            o = torch.zeros((1, tl, hq, d), device="cuda")
            lse = torch.full((1, hq, tl), F.NEG_BIG, device="cuda")
            for j in range(i + 1):
                offs = (0, 0) if zero_offsets else (i * tl, j * tl)
                ob, lb = F.flash_attention_block(
                    q[:, i * tl:(i + 1) * tl], k[:, j * tl:(j + 1) * tl],
                    v[:, j * tl:(j + 1) * tl], q_offset=offs[0],
                    k_offset=offs[1])
                o, lse = F.combine_attention_chunks(o, lse, ob, lb)
            outs.append(o)
        return torch.cat(outs, dim=1)

    got = chunked(False)
    got_g = torch.autograd.grad(got, (q, k, v), do)
    want = F.FlashAttentionFunction.apply(q, k, v, None, None, None, True,
                                          None, None, False)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    use = tolerance_use(got, want, dtype)
    g_use = {label: bwd_tolerance_use(a, b, dtype)
             for label, a, b in zip(("dq", "dk", "dv"), got_g, want_g)}
    with torch.no_grad():
        miss = tolerance_use(chunked(True), want, dtype)
    if use > 1.0 or max(g_use.values()) > 1.0 or miss < BLOCK_MISS_MIN_USE:
        raise AssertionError(
            f"flash_block composition: forward uses {use}, grads {g_use}, "
            f"offsets-zeroed control {miss} (must exceed "
            f"{BLOCK_MISS_MIN_USE})")
    del q, k, v, do, got, got_g, want, want_g
    torch.cuda.empty_cache()
    return {"T": t, "chunks": n, "dtype": "float32", "heads": [hq, hkv],
            "forward_tolerance_use": use, "grad_tolerance_use": g_use,
            "offsets_zeroed_tolerance_use": miss}


# Tolerances of the MoE FFN kernels vs their plain versions, same inputs.
# Same rule as above, other constants. fp32: both sides multiply in exact
# fp32 and differ in the order of sums only. bf16: both accumulate the bf16
# products in fp32 (tensor cores vs fp32 products of the widened values),
# then each rounds the hidden to bf16 before the down product — two fp32
# values that close may round to neighbouring bf16 values, and such a flip
# of one hidden value moves a whole output row by up to one bf16 step of
# that value's contribution, a share of the row's size — and each rounds
# y * probs to bf16 once: one bf16 step of the element. The negative
# controls (a dropped tile, a tile given the wrong expert, a lost 64-wide
# chunk of i), emulated with the plain version, must break the rule.
# In bf16, B5, B6 and B7 run on the sm_90 core (csrc/moe_ffn_sm90.cuh: the
# hidden through device memory in bf16, the same rounding points; B6 is
# B5's arithmetic on gathered rows and must give B5's bits);
# tests/test_torch_moe_ffn_sm90.py emulates the core's arithmetic on the
# CPU against the same rule.
MOE_ATOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6}
MOE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
MOE_ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
MOE_TOLERANCE = {
    "bf16": [MOE_ATOL[torch.bfloat16], MOE_RTOL[torch.bfloat16],
             MOE_ROW_RTOL[torch.bfloat16]],
    "fp32": [MOE_ATOL[torch.float32], MOE_RTOL[torch.float32],
             MOE_ROW_RTOL[torch.float32]],
    "rule": TOLERANCE["rule"],
}
MOE_KERNELS = ("moe_ffn_aligned", "moe_ffn_gather", "moe_ffn_gather_combine")
# the MoE kernels' own device time: every kernel of csrc/moe_ffn*.cu is named
# ffn_* (the sm_90 core's ffn_sm90_gate_up_* and ffn_sm90_down_*)
MOE_KERNEL_TAG = "ffn_"
MOE_SOURCES = dict.fromkeys(MOE_KERNELS,
                            "d9d_tpu_torch/csrc/moe_ffn_sm90.cuh")
# the device kernels of one bf16 call of each wrapper, in launch order
MOE_CORE_KERNELS = {
    "moe_ffn_aligned": ("ffn_sm90_gate_up_aligned", "ffn_sm90_down_aligned"),
    "moe_ffn_gather": ("ffn_sm90_gate_up_gather", "ffn_sm90_down_gather"),
    "moe_ffn_gather_combine": ("ffn_sm90_gate_up_gather",
                               "ffn_sm90_down_combine"),
}


def moe_tolerance_use(got, want, dtype):
    want = want.float()
    allowed = (MOE_ATOL[dtype] + MOE_RTOL[dtype] * want.abs()
               + MOE_ROW_RTOL[dtype] * want.abs().amax(dim=-1, keepdim=True))
    return float(((got.float() - want).abs() / allowed).max())


def _moe_problem(gen, dtype, n, k, e, h, inter, route="router"):
    """Tokens, expert weights and routing. The weights are uniform with
    variance 1/(3 in) — E times the model init's variance, so that outputs
    are of order 0.1-1 and a rounding step is visible. ``route``: "router" —
    softmax top-k of a random bf16 router, renormalized (as TopKRouter);
    "subset" — only experts 0..e/8-1 are chosen (most experts empty);
    "one" — every pair on expert 3 (k must be 1); "cyclic" — pair p on
    expert p % e with random renormalized probs, so every group holds
    n*k/e rows (one row per expert at n*k = e; exact tile multiples when
    n*k/e is one)."""
    from d9d_tpu_torch.nn.moe import top_k_indices
    from d9d_tpu_torch.ops.moe import sort_tokens_by_expert

    x = _rand((n, h), dtype, gen)

    def uni(shape, fan_in):
        bound = (1.0 / fan_in) ** 0.5  # variance 1/(3 fan_in)
        return ((torch.rand(shape, device="cuda", generator=gen) * 2 - 1)
                * bound).to(dtype)

    wg, wu = uni((e, h, inter), h), uni((e, h, inter), h)
    wd = uni((e, inter, h), inter)
    if route == "one":
        ids = torch.full((n, k), 3, dtype=torch.int64, device="cuda")
        probs = torch.ones((n, k), device="cuda")
    elif route == "cyclic":
        ids = (torch.arange(n * k, device="cuda") % e).reshape(n, k)
        probs = torch.rand((n, k), device="cuda", generator=gen) + 0.1
        probs = probs / probs.sum(-1, keepdim=True)
    else:
        live = e if route == "router" else max(e // 8, k)
        wr = _rand((h, live), torch.bfloat16, gen) * h ** -0.5
        scores = torch.softmax((x.to(torch.bfloat16) @ wr).float(), dim=-1)
        ids = top_k_indices(scores, k)
        probs = torch.gather(scores, 1, ids)
        probs = probs / (probs.sum(-1, keepdim=True) + 1e-20)
    return x, (wg, wu, wd), probs, sort_tokens_by_expert(ids, e)


def _moe_work(kernel, n, k, h, inter, meta, sort, dtype):
    """Operations and bytes each MoE kernel's work needs on this data: the
    real pairs' three products (6 M h i flops), the weights of the experts
    that got a row, read once, the rows in and the output out once. The
    aligned kernel's input is its M real rows and their probs: its pad rows
    have prob 0 and no source, so the function never needs them (the core
    reads no row of an all-padding tile); its whole [m_pad, h] output is
    written."""
    el = torch.empty((), dtype=dtype).element_size()
    m = n * k
    used = int((sort.group_sizes > 0).sum())
    weights = 3 * used * h * inter * el
    idx = meta.pair_src.numel() * 4 + meta.gid.numel() * 4
    if kernel == "moe_ffn_aligned":
        nbytes = weights + m * h * el + m * 4 + meta.m_pad * h * el + idx
    elif kernel == "moe_ffn_gather":
        nbytes = weights + n * h * el + m * 4 + meta.m_pad * h * el + idx
    else:
        nbytes = weights + n * h * el + m * 4 + n * h * el + idx
    flops = 6.0 * m * h * inter
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    by_ops, by_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def check_moe_ffn(gen):
    """The three MoE FFN kernels against their plain versions, fp32 and
    bf16, at Qwen3-30B-A3B widths (h 2048, i 768, 128 experts, top-8) and
    at edge cases; timed at one training microbatch (4096 tokens)."""
    from d9d_tpu_torch.ops import moe_ffn as mf

    cases = []
    worst = {n_: {torch.float32: 0.0, torch.bfloat16: 0.0}
             for n_ in MOE_KERNELS}
    worst_use = dict.fromkeys(MOE_KERNELS, 0.0)

    def run_all(dtype, x, w, probs, sort, e):
        n, k = probs.shape
        bm = mf.kernel_block_m(dtype, x.shape[1], w[0].shape[2])
        meta = mf.aligned_metadata(sort, e, bm)
        pf = probs.reshape(-1).float().contiguous()
        a, pa = mf._gathered_rows(x, pf, meta.pair_src, k)
        a, pa = a.contiguous(), pa.contiguous()
        args = {
            "moe_ffn_aligned": ((a, pa, meta.gid, meta.pair_src, *w), {}),
            "moe_ffn_gather": ((x, pf, meta.gid, meta.pair_src, *w),
                               {"top_k": k}),
            "moe_ffn_gather_combine": ((x, pf, meta.gid, meta.pair_src, *w),
                                       {"top_k": k}),
        }
        fns = {"moe_ffn_aligned": (mf.moe_ffn_aligned,
                                   mf.moe_ffn_aligned_plain),
               "moe_ffn_gather": (mf.moe_ffn_gather, mf.moe_ffn_gather_plain),
               "moe_ffn_gather_combine": (mf.moe_ffn_gather_combine,
                                          mf.moe_ffn_gather_combine_plain)}
        return meta, args, fns

    def compare(tag, dtype, n, k, e, h, inter, route="router"):
        x, w, probs, sort = _moe_problem(gen, dtype, n, k, e, h, inter, route)
        meta, args, fns = run_all(dtype, x, w, probs, sort, e)
        row = {"case": tag, "dtype": str(dtype).split(".")[-1],
               "shape": {"N": n, "K": k, "E": e, "h": h, "i": inter,
                         "block_m": meta.pair_src.numel() // meta.gid.numel(),
                         "m_pad": meta.m_pad,
                         "tiles": meta.gid.numel(),
                         "all_pad_tiles": int(
                             (meta.pair_src[::meta.pair_src.numel()
                                            // meta.gid.numel()] < 0).sum()),
                         "empty_experts": int((sort.group_sizes == 0).sum())}}
        outs, gots = {}, {}
        for name in MOE_KERNELS:
            kern, plain = fns[name]
            pos, kw = args[name]
            got = gots[name] = kern(*pos, **kw)
            torch.cuda.synchronize()
            want = plain(*pos, **kw)
            err = max_err(got, want)
            use = moe_tolerance_use(got, want, dtype)
            finite = bool(torch.isfinite(got.float()).all())
            if not finite or use > 1.0:
                raise AssertionError(
                    f"{name} {tag} {dtype}: max_abs_err {err} uses {use} of "
                    f"its tolerance (finite: {finite})")
            worst[name][dtype] = max(worst[name][dtype], err)
            worst_use[name] = max(worst_use[name], use)
            row[name] = {"max_abs_err": err, "tolerance_use": use}
            outs[name] = want
        # the three agree on the combined output too
        n_, k_ = probs.shape
        for name in ("moe_ffn_aligned", "moe_ffn_gather"):
            comb = outs[name].index_select(0, meta.dest_aligned).reshape(
                n_, k_, -1).float().sum(1)
            use = moe_tolerance_use(comb.to(dtype),
                                    outs["moe_ffn_gather_combine"], dtype)
            row[f"{name}_combined_vs_combine_kernel"] = use
        # B6 is B5's arithmetic on gathered rows: the same bits (bf16: the
        # same core; fp32: the same body)
        same = torch.equal(gots["moe_ffn_gather"], gots["moe_ffn_aligned"])
        row["gather_equals_aligned_bitwise"] = same
        if dtype == torch.bfloat16 and not same:
            raise AssertionError(
                f"moe_ffn_gather {tag}: differs from moe_ffn_aligned by "
                f"{max_err(gots['moe_ffn_gather'], gots['moe_ffn_aligned'])}")
        del gots
        cases.append(row)
        return x, w, probs, sort, meta, args, fns

    # edge cases at full widths, small token counts; one at the example's
    # widths (pretrain.json: h = i = 128, 16 experts, top-2)
    for dtype in (torch.bfloat16, torch.float32):
        compare("router", dtype, 512, 8, 128, 2048, 768)
        compare("empty_experts", dtype, 256, 8, 128, 2048, 768, route="subset")
        compare("one_expert", dtype, 256, 1, 128, 2048, 768, route="one")
        compare("nk_not_multiple_of_block_m", dtype, 100, 3, 16, 2048, 768)
        compare("example_widths", dtype, 1024, 2, 16, 128, 128)
        # one row in every expert; every group exactly two 128-row tiles
        # (eight of fp32's 32)
        compare("one_row_per_expert", dtype, 16, 8, 128, 2048, 768,
                route="cyclic")
        compare("groups_on_block_m_multiples", dtype, 4096, 8, 128, 2048,
                768, route="cyclic")
        # one decode step of the serving batch: 64 pairs, m_pad 16512 in
        # bf16, at least 65 of its 129 tiles all padding
        compare("decode_step", dtype, 8, 8, 128, 2048, 768)
    # beyond the old bf16 B6 body's shared-memory cap (i <= 1536)
    compare("i_1600", torch.bfloat16, 512, 8, 128, 2048, 1600)
    compare("timed_fp32", torch.float32, 4096, 8, 128, 2048, 768)
    x, w, probs, sort, meta, args, fns = compare(
        "timed", torch.bfloat16, 4096, 8, 128, 2048, 768)
    n, k = probs.shape
    e, h, inter = w[0].shape

    # negative controls on the aligned kernel's plain output, timed shape
    pos, _ = args["moe_ffn_aligned"]
    want = mf.moe_ffn_aligned_plain(*pos)
    bm = meta.pair_src.numel() // meta.gid.numel()
    dropped = want.clone()
    dropped[:bm] = 0
    gid_wrong = meta.gid.clone()
    gid_wrong[0] = (gid_wrong[0] + 1) % e
    wrong = mf.moe_ffn_aligned_plain(pos[0], pos[1], gid_wrong, *pos[3:])
    wg, wu, wd = w
    lost = mf.moe_ffn_aligned_plain(
        *pos[:4], wg, wu, torch.cat([torch.zeros_like(wd[:, :64]),
                                     wd[:, 64:]], dim=1))
    first = slice(0, bm)
    controls = {
        "dropped_tile": moe_tolerance_use(dropped[first], want[first],
                                          torch.bfloat16),
        "wrong_expert": moe_tolerance_use(wrong[first], want[first],
                                          torch.bfloat16),
        "lost_i_chunk": moe_tolerance_use(lost, want, torch.bfloat16),
    }
    if min(controls.values()) <= 1.0:
        raise AssertionError(f"a negative control passes the rule: {controls}")

    # B7 adds a token's top-k contributions by fp32 atomics, in the order
    # they land (ROADMAP C6, an accepted divergence): two runs on the same
    # inputs may differ in the last bits; read by how much
    pos, kw = args["moe_ffn_gather_combine"]
    first_run = mf.moe_ffn_gather_combine(*pos, **kw)
    repeat = [max_err(mf.moe_ffn_gather_combine(*pos, **kw), first_run)
              for _ in range(3)]
    torch.cuda.synchronize()
    combine_repeat = {"runs": 4, "max_abs_diff_from_first": max(repeat),
                      "bitwise_equal_runs": sum(r == 0.0 for r in repeat),
                      "max_abs_of_output": float(first_run.float().abs().max())}
    del first_run

    decode = _moe_decode_timing(gen, run_all)

    kernels = []
    timed = {}
    per_call = {}
    # the bound on the layout of 64-row tiles, beside the one taken
    meta64 = mf.aligned_metadata(sort, e, 64)
    for name in MOE_KERNELS:
        kern, plain = fns[name]
        pos, kw = args[name]

        def call():
            return kern(*pos, **kw)

        ms = time_ms(call, iters=10, warmup=2)
        dev_ms, dev_all_ms, per_call[name] = device_time(
            call, MOE_KERNEL_TAG, iters=10, warmup=1)
        _check_core_kernels(name, per_call[name])
        plain_ms = time_ms(lambda: plain(*pos, **kw), iters=2, warmup=1)
        work = _moe_work(name, n, k, h, inter, meta, sort, torch.bfloat16)
        bound64 = _moe_work(name, n, k, h, inter, meta64, sort,
                            torch.bfloat16)["bound_ms"]
        timed[name] = {"ms": ms, "device_ms": dev_ms,
                       "device_ms_all_kernels": dev_all_ms,
                       "plain_ms": plain_ms, "bound_ms_at_block_m_64": bound64,
                       **work}
    chain_ms, chain_info = _moe_library_chain(x, w, probs, sort)
    for name, line in (("moe_ffn_aligned", 371), ("moe_ffn_gather", 438),
                       ("moe_ffn_gather_combine", 475)):
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": MOE_SOURCES[name],
            "replaces": f"d9d_tpu/ops/moe_pallas.py:{line}",
            "max_abs_err": worst[name][torch.bfloat16],
            "max_abs_err_fp32": worst[name][torch.float32],
            "tolerance_use": worst_use[name],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "device_ms_all_kernels": t["device_ms_all_kernels"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_ms_at_block_m_64": t["bound_ms_at_block_m_64"],
            "library_ms": None, "library_chain_ms": chain_ms,
        })
    bm = meta.pair_src.numel() // meta.gid.numel()
    real_tiles = int((meta.pair_src[::bm] >= 0).sum())
    return kernels, {
        "cases": cases, "tolerance": MOE_TOLERANCE,
        "negative_controls": controls,
        "gather_combine_repeat": combine_repeat,
        "timed_shape": {"N": n, "K": k, "E": e, "h": h, "i": inter,
                        "dtype": "bfloat16", "block_m": bm,
                        "m_pad": meta.m_pad, "m_pad_at_block_m_64": meta64.m_pad,
                        "tiles": meta.gid.numel(), "real_tiles": real_tiles,
                        "rows_computed": real_tiles * bm,
                        "pad_rows_computed": real_tiles * bm - n * k,
                        "pairs": n * k,
                        "experts_used": int((sort.group_sizes > 0).sum())},
        "kernels_per_call": per_call,
        "decode_step": decode,
        "ms_is": "the wrapper: aligned on a prepared aligned buffer; "
                 "gather_combine includes its fp32 zero fill and cast",
        "device_ms_is": "torch.profiler: the ffn_* kernels' own device time "
                        "per call (the sm_90 core's gate-up and down "
                        "launches); device_ms_all_kernels adds the wrapper's "
                        "other launches (B7's zero fill and cast)",
        "library_ms_is": "null: no single PyTorch call computes a grouped "
                         "SwiGLU FFN",
        "library_chain": chain_info,
        "bound_from": {n_: {"flops": timed[n_]["flops"],
                            "bytes": timed[n_]["bytes"]}
                       for n_ in MOE_KERNELS},
    }


def _check_core_kernels(name, per_call):
    """A bf16 call of ``name`` ran the sm_90 core's two kernels, exactly
    once each, and no other expert-FFN kernel (null when the profiler saw
    nothing)."""
    if per_call is None:
        return
    # profiler keys are demangled signatures: d9d::sm90::<kernel>(...)
    ffn = {k.split("(")[0].split("::")[-1]: v["calls"]
           for k, v in per_call.items() if MOE_KERNEL_TAG in k}
    want = MOE_CORE_KERNELS[name]
    if sorted(ffn) != sorted(want) or any(c != 1 for c in ffn.values()):
        raise AssertionError(
            f"{name}: device kernels per call {ffn}, expected one each of "
            f"{want}")


def _moe_decode_timing(gen, run_all):
    """The three bf16 kernels at one decode step of the serving batch (8
    tokens, top-8 of 128 experts at Qwen3-30B-A3B widths): the wrapper loop's
    ms, each kernel's device ms and the bound on this data."""
    n, k, e, h, inter = 8, 8, 128, 2048, 768
    x, w, probs, sort = _moe_problem(gen, torch.bfloat16, n, k, e, h, inter)
    meta, args, fns = run_all(torch.bfloat16, x, w, probs, sort, e)
    bm = meta.pair_src.numel() // meta.gid.numel()
    out = {"shape": {"N": n, "K": k, "E": e, "h": h, "i": inter,
                     "block_m": bm, "m_pad": meta.m_pad,
                     "tiles": meta.gid.numel(),
                     "real_tiles": int((meta.pair_src[::bm] >= 0).sum()),
                     "experts_used": int((sort.group_sizes > 0).sum())}}
    for name in MOE_KERNELS:
        kern = fns[name][0]
        pos, kw = args[name]

        def call():
            return kern(*pos, **kw)

        ms = time_ms(call, iters=20, warmup=3)
        dev_ms, dev_all_ms, per = device_time(call, MOE_KERNEL_TAG, iters=20)
        _check_core_kernels(name, per)
        out[name] = {"ms": ms, "device_ms": dev_ms,
                     "device_ms_all_kernels": dev_all_ms,
                     "kernels_per_call": per,
                     **_moe_work(name, n, k, h, inter, meta, sort,
                                 torch.bfloat16)}
    return out


def _moe_library_chain(x, w, probs, sort):
    """Yardstick only (the port never calls it): the same function through
    a chain of library calls on expert-sorted rows — three
    ``torch._grouped_mm`` in bf16, ``silu`` times up, the prob scale.
    Returns (ms, description); ms is None if the call is refused here."""
    import torch.nn.functional as F

    from d9d_tpu_torch.ops.moe import permute_tokens

    xs, ps = permute_tokens(x, probs, sort)
    offs = torch.cumsum(sort.group_sizes, 0).to(torch.int32)
    wg, wu, wd = w

    def chain():
        g = torch._grouped_mm(xs, wg, offs=offs)
        u = torch._grouped_mm(xs, wu, offs=offs)
        y = torch._grouped_mm(F.silu(g) * u, wd, offs=offs)
        return y * ps[:, None].to(y.dtype)

    info = {"is": "chain of library calls, not one call: torch._grouped_mm "
                  "(gate), (up), silu*up, torch._grouped_mm (down), * probs; "
                  "bf16, on expert-sorted rows (permute not timed)"}
    try:
        chain()
    except (RuntimeError, NotImplementedError) as exc:  # yardstick only
        info["refused"] = str(exc)[:200]
        return None, info
    return time_ms(chain, iters=10, warmup=2), info


# Stochastic rounding (B10) vs its plain version: bitwise. Both compute the
# same counter-hash bits from (seed, element index) and the same integer
# rule, so any differing bit is a fault. The semantic checks hold the rule
# itself at 2^24 draws: the share of elements rounded up estimates the
# position of x between its bf16 neighbours with standard deviation at most
# sqrt(0.25 / 2^24) = 1.2e-4, so 5e-4 is four of them; round-to-nearest
# must fail the same check (its share is 0 or 1).
SR_SHARE_TOL = 5e-4
SR_DRAWS = 2 ** 24
# fp32 bit patterns placed first in every input: ±0, denormals, ±inf, NaNs
# (quiet, signalling, negative), the largest finite values (which may round
# up to inf, as the JAX rule does) and values exact in bf16
SR_SPECIAL_BITS = (0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
                   0x00400000, 0x7F800000, 0xFF800000, 0x7FC00000,
                   0x7F800001, 0xFFFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                   0x7F7F8000, 0x3F800000, 0xC0000000)


def _sr_input(shape, gen):
    x = torch.randn(shape, device="cuda", generator=gen)
    flat = x.view(-1)
    special = torch.tensor(SR_SPECIAL_BITS, dtype=torch.int64)
    special = torch.where(special >= 2 ** 31, special - 2 ** 32, special)
    k = min(len(SR_SPECIAL_BITS), flat.numel())
    flat[:k] = special[:k].to(torch.int32).view(torch.float32).cuda()
    return x


def _sr_share_ok(fn):
    """The rounding rule at SR_DRAWS draws per fraction: lands on the two
    neighbours of 1 + f*2^-7 and rounds up a share f of the time."""
    lo, step = 1.0, 2.0 ** -7
    shares = {}
    ok = True
    for f in (0.125, 0.25, 0.5, 0.75):
        x = torch.full((SR_DRAWS,), lo + f * step, device="cuda")
        out = fn(x, f).float()
        up = out == lo + step
        on_grid = bool((up | (out == lo)).all())
        shares[f] = float(up.double().mean())
        ok = ok and on_grid and abs(shares[f] - f) <= SR_SHARE_TOL
    return ok, shares


# FSDP's pieces at Qwen3-8B widths and dp_shard 2: the gate/up projections
# [12288, 4096] cut on dim 1 (columns: one run of the flat index per row),
# the embedding [151936, 4096] cut on dim 0 (rows: one run); narrow shapes
# whose pieces' rows are not a multiple of 4 (the element-wise strided
# path), cut in 3 as torch.chunk cuts them; and the pieces of tensor
# parallelism with FSDP at tp 2 x dp_shard 2: q_proj [4096, 4096] cut by tp
# on dim 0 and by the fsdp axes on dim 1 (a block), the vocab table cut by
# tp and then, inside each tp slice, by the fsdp axes on dim 0 (FSDP2's
# strided piece). Each case: (shape, ((dim, parts), ...) outer cut first)
SR_SHARD_CASES = (((12288, 4096), ((1, 2),)), ((151936, 4096), ((0, 2),)),
                  ((1001, 37), ((1, 3),)), ((1001, 37), ((0, 3),)),
                  ((4096, 4096), ((0, 2), (1, 2))),
                  ((151936, 4096), ((0, 2), (0, 2))))


def _nested_bounds(shape, cuts, ranks):
    """``[(dim, start, length)]`` of the piece at ``ranks`` (one rank per
    cut), each cut torch.chunk's of what the cuts before it left
    (``parallel/shards.py`` ``shard_bounds``)."""
    bounds = {}
    for (dim, parts), r in zip(cuts, ranks):
        lo, n = bounds.get(dim, (0, shape[dim]))
        chunk = -(-n // parts)
        start = min(r * chunk, n)
        bounds[dim] = (lo + start, max(0, min(chunk, n - start)))
    return [(d, lo, n) for d, (lo, n) in sorted(bounds.items())]


def _sr_shard_cases(gen, seed, bits):
    """B10 on pieces at their index offsets: each piece bit for bit
    against the plain version at the same offsets, and against the same
    elements of the whole tensor's rounding; the widest column piece and
    the block piece timed."""
    import itertools

    from d9d_tpu_torch.ops.stochastic import (
        shard_index,
        stochastic_round_to_bf16,
        stochastic_round_to_bf16_plain,
    )

    cases, timed = [], {}
    for shape, cuts in SR_SHARD_CASES:
        x = _sr_input(shape, gen)
        whole = bits(stochastic_round_to_bf16(x, seed))
        for ranks in itertools.product(*(range(p) for _, p in cuts)):
            bounds = _nested_bounds(shape, cuts, ranks)
            idx = [slice(None)] * len(shape)
            for d, a, n in bounds:
                idx[d] = slice(a, a + n)
            idx = tuple(idx)
            piece = x[idx].contiguous()
            off, cols, stride = shard_index(shape, bounds)
            kw = dict(index_offset=off, cols=cols, row_stride=stride)
            got = bits(stochastic_round_to_bf16(piece, seed, **kw))
            torch.cuda.synchronize()
            vs_plain = int((got != bits(stochastic_round_to_bf16_plain(
                piece, seed, **kw))).sum())
            vs_whole = int((got != whole[idx]).sum())
            if vs_plain or vs_whole:
                raise AssertionError(
                    f"stochastic_round piece {ranks} of {list(shape)} cut "
                    f"{cuts}: {vs_plain} bits differ from the plain "
                    f"version, {vs_whole} from the whole tensor's rounding")
            cases.append({"shape": list(shape), "cuts": cuts,
                          "piece": list(ranks), "bounds": bounds,
                          "index": [off, cols, stride],
                          "differing_bits_vs_plain": vs_plain,
                          "differing_bits_vs_whole": vs_whole})
            kind = ("block" if len(bounds) == 2 else
                    "column" if bounds[0][0] == 1 else None)
            if kind is not None and kind not in timed:
                m = piece.numel()
                timed[kind] = {
                    "shape": list(piece.shape), "of": list(shape),
                    "index": [off, cols, stride],
                    "ms": time_ms(lambda: stochastic_round_to_bf16(
                        piece, seed, **kw), iters=10, warmup=2),
                    "whole_ms": time_ms(lambda: stochastic_round_to_bf16(
                        piece, seed), iters=10, warmup=2),
                    "bound_ms": 1e3 * 6 * m / H100_BYTES_PER_S}
            del piece, got
        del x, whole
        torch.cuda.empty_cache()
    return cases, timed


def check_stochastic_round(gen):
    from d9d_tpu_torch.ops.stochastic import (
        fold_seed,
        stochastic_round_to_bf16,
        stochastic_round_to_bf16_plain,
    )

    def bits(t):
        return t.view(torch.int16)

    cases = []
    seed = fold_seed(0, 1, 0, 0)
    timed = {}
    for shape in ((1,), (1000003,), (4096, 12288), (151936, 4096)):
        x = _sr_input(shape, gen)
        got = stochastic_round_to_bf16(x, seed)
        torch.cuda.synchronize()
        want = stochastic_round_to_bf16_plain(x, seed)
        differ = int((bits(got) != bits(want)).sum())
        finite = torch.isfinite(want)
        err = max_err(got[finite], want[finite]) if bool(finite.any()) else 0.0
        if differ:
            raise AssertionError(
                f"stochastic_round {list(shape)}: {differ} elements differ "
                f"from the plain version")
        case = {"shape": list(shape), "differing_bits": differ,
                "max_abs_err": err}
        if x.numel() >= 4096 * 12288:
            n = x.numel()
            case.update(
                ms=time_ms(lambda: stochastic_round_to_bf16(x, seed),
                           iters=10, warmup=2),
                plain_ms=time_ms(
                    lambda: stochastic_round_to_bf16_plain(x, seed),
                    iters=2, warmup=1),
                cast_ms=time_ms(lambda: x.to(torch.bfloat16), iters=10,
                                warmup=2),
                bound_ms=1e3 * 6 * n / H100_BYTES_PER_S)
            timed[shape] = case
        cases.append(case)
        del x, got, want, finite
        torch.cuda.empty_cache()

    # the vector path needs 16-byte aligned input and 8-byte aligned output;
    # shifted views take the element-wise path, and write in place
    x = _sr_input((4099,), gen)
    buf = torch.empty(4100, dtype=torch.float32, device="cuda")
    buf[1:] = x
    out = torch.zeros(4100, dtype=torch.bfloat16, device="cuda")
    got = stochastic_round_to_bf16(buf[1:], seed, out=out[1:])
    want = stochastic_round_to_bf16_plain(x, seed)
    if got.data_ptr() != out[1:].data_ptr() or not torch.equal(
            bits(out[1:]), bits(want)) or bits(out)[0] != 0:
        raise AssertionError("stochastic_round: unaligned views differ")
    cases.append({"shape": [4099], "case": "unaligned in and out, in place",
                  "differing_bits": 0})

    ok, shares = _sr_share_ok(
        lambda x, f: stochastic_round_to_bf16(x, fold_seed(9, int(8 * f))))
    rtn_ok, rtn_shares = _sr_share_ok(lambda x, f: x.to(torch.bfloat16))
    if not ok or rtn_ok:
        raise AssertionError(
            f"stochastic_round shares {shares} (want within {SR_SHARE_TOL}), "
            f"round-to-nearest control {rtn_shares} must fail")
    exact = torch.randn(SR_DRAWS, device="cuda", generator=gen).to(
        torch.bfloat16)
    nonfinite = torch.tensor([float("inf"), float("-inf"), float("nan")],
                             device="cuda")
    y = stochastic_round_to_bf16(nonfinite, seed).float()
    if not (torch.equal(stochastic_round_to_bf16(exact.float(), seed), exact)
            and y[0] == float("inf") and y[1] == float("-inf")
            and bool(torch.isnan(y[2]))):
        raise AssertionError("stochastic_round: exact or non-finite values "
                             "changed")
    x = torch.randn(1 << 20, device="cuda", generator=gen)
    a = bits(stochastic_round_to_bf16(x, seed))
    same = torch.equal(a, bits(stochastic_round_to_bf16(x, seed)))
    other = {f"count{c}_leaf{l}_role{r}":
             float((a != bits(stochastic_round_to_bf16(
                 x, fold_seed(0, c, l, r)))).double().mean())
             for c, l, r in ((2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 2))}
    if not same or min(other.values()) < 0.2:
        raise AssertionError(f"stochastic_round seeds: same seed same bits "
                             f"{same}, share differing {other}")

    shard_cases, shard_timed = _sr_shard_cases(gen, seed, bits)
    main = timed[(4096, 12288)]
    return {
        "name": "stochastic_round", "route": "cuda",
        "source": "d9d_tpu_torch/csrc/stochastic.cu",
        "replaces": "d9d_tpu/ops/stochastic.py:85",
        "max_abs_err": max(c.get("max_abs_err", 0.0) for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "cast_ms": main["cast_ms"],
        "ms_embedding_leaf": timed[(151936, 4096)]["ms"],
        "bound_ms_embedding_leaf": timed[(151936, 4096)]["bound_ms"],
        "ms_column_piece": shard_timed["column"]["ms"],
        "bound_ms_column_piece": shard_timed["column"]["bound_ms"],
        "ms_block_piece": shard_timed["block"]["ms"],
        "bound_ms_block_piece": shard_timed["block"]["bound_ms"],
    }, {
        "cases": cases, "shard_cases": shard_cases,
        "piece_timing": shard_timed, "tolerance": "bitwise",
        "timed_shape": [4096, 12288],
        "shares_up": shares, "share_tol": SR_SHARE_TOL, "draws": SR_DRAWS,
        "round_to_nearest_control_shares": rtn_shares,
        "same_seed_same_bits": same, "share_differing_by_seed": other,
        "library": "none: no single PyTorch call rounds stochastically; "
                   "cast_ms is x.to(bfloat16), round to nearest, the same "
                   "bytes",
    }


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1, detail1 = check_flash_fwd(gen)
    say(phase="kernels", kernel="flash_fwd", **detail1)
    k2, detail2 = check_flash_decode(gen)
    say(phase="kernels", kernel="flash_decode", **detail2)
    k9, detail9 = check_flash_decode_paged(gen)
    say(phase="kernels", kernel="flash_decode_paged", **detail9)
    torch.cuda.empty_cache()
    bwd, detail3 = check_flash_bwd(gen)
    say(phase="kernels", kernel="flash_bwd", **detail3)
    torch.cuda.empty_cache()
    kb, detailb = check_flash_block(gen)
    say(phase="kernels", kernel="flash_block", **detailb)
    torch.cuda.empty_cache()
    moe, detail4 = check_moe_ffn(gen)
    say(phase="kernels", kernel="moe_ffn", **detail4)
    torch.cuda.empty_cache()
    k10, detail10 = check_stochastic_round(gen)
    say(phase="kernels", kernel="stochastic_round", **detail10)
    torch.cuda.empty_cache()
    return [k1, k2, k9, *bwd, kb, *moe, k10]


# ---------------------------------------------------------------------------
# launch counters


KERNEL_NAMES = ("flash_fwd", "flash_decode", "flash_decode_paged",
                "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused",
                "flash_block") + MOE_KERNELS + ("stochastic_round",)


def _moe_wrappers():
    from d9d_tpu_torch.ops import moe_ffn as mf

    return {"moe_ffn_aligned": mf.moe_ffn_aligned,
            "moe_ffn_gather": mf.moe_ffn_gather,
            "moe_ffn_gather_combine": mf.moe_ffn_gather_combine}


def reset_counters(model=None):
    from d9d_tpu_torch.ops.attention.decode import (
        flash_decode,
        flash_decode_paged,
    )
    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention,
        flash_attention_bwd,
    )
    from d9d_tpu_torch.ops.moe import group_sizes_on_host
    from d9d_tpu_torch.ops.stochastic import stochastic_round_to_bf16

    for fn in (flash_attention, flash_decode, flash_decode_paged,
               stochastic_round_to_bf16, *_moe_wrappers().values()):
        fn.launches = 0
        fn.plain_calls = 0
    for name in ("dq_launches", "dkv_launches", "fused_launches",
                 "block_launches", "plain_calls"):
        setattr(flash_attention_bwd, name, 0)
    flash_attention.block_launches = 0
    group_sizes_on_host.readbacks = 0
    if model is not None:
        model.sdpa.eager_calls = 0


def read_counters(model=None):
    """Kernel launches by name, the plain-version and eager calls (0 on a
    card path), and the MoE backward's group-size readbacks."""
    from d9d_tpu_torch.ops.attention.decode import (
        flash_decode,
        flash_decode_paged,
    )
    from d9d_tpu_torch.ops.attention.flash import (
        flash_attention,
        flash_attention_bwd,
    )
    from d9d_tpu_torch.ops.moe import group_sizes_on_host
    from d9d_tpu_torch.ops.stochastic import stochastic_round_to_bf16

    moe = _moe_wrappers()
    out = {
        "flash_fwd": flash_attention.launches,
        "flash_decode": flash_decode.launches,
        "flash_decode_paged": flash_decode_paged.launches,
        "flash_bwd_dq": flash_attention_bwd.dq_launches,
        "flash_bwd_dkv": flash_attention_bwd.dkv_launches,
        "flash_bwd_fused": flash_attention_bwd.fused_launches,
        # the flash kernels' launches in block mode (B4: ring steps); they
        # are counted under flash_fwd / flash_bwd_* as well
        "flash_block": flash_attention.block_launches
        + flash_attention_bwd.block_launches,
    }
    out.update({name: fn.launches for name, fn in moe.items()})
    out["stochastic_round"] = stochastic_round_to_bf16.launches
    out["plain_calls"] = (flash_attention.plain_calls + flash_decode.plain_calls
                          + flash_decode_paged.plain_calls
                          + flash_attention_bwd.plain_calls
                          + stochastic_round_to_bf16.plain_calls
                          + sum(fn.plain_calls for fn in moe.values()))
    out["eager_calls"] = model.sdpa.eager_calls if model is not None else 0
    out["moe_readbacks"] = group_sizes_on_host.readbacks
    return out


def counts(**launches):
    """A counter dict: the given launches, every other count 0."""
    out = dict.fromkeys(
        KERNEL_NAMES + ("plain_calls", "eager_calls", "moe_readbacks"), 0)
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
    contiguous = [out[r] for r in rids]

    # the paged batcher (page 4: the prompts are prefixes of one sequence,
    # so later ones hit the prefix cache), card through the paged kernel vs
    # CPU through its plain version; fp32 pools also vs the contiguous
    # streams, int8 pools card vs CPU as a share of equal tokens
    def paged(model, quant):
        b = ContinuousBatcher(model, batch_size=2, chunk_size=4, page_size=4,
                              kv_quant=quant)
        ids_ = [b.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        res = b.drain()
        b._kv.check_invariants()
        return [res[r] for r in ids_], b._kv.prefix_hits, b.stats.device_steps

    paged_info = {}
    for quant in (None, "int8"):
        reset_counters(gpu)
        card, hits, steps = paged(gpu, quant)
        torch.cuda.synchronize()
        got_counts = read_counters(gpu)
        if got_counts != counts(flash_decode_paged=steps * cfg.num_layers):
            raise AssertionError(
                f"small model paged {quant}: counters {got_counts}")
        host, host_hits, _ = paged(cpu, quant)
        if hits < 1 or host_hits != hits:
            raise AssertionError(
                f"small model paged {quant}: prefix hits {hits}/{host_hits}")
        n_tok = sum(len(x) for x in card)
        share = sum(a == b for x, y in zip(card, host)
                    for a, b in zip(x, y)) / n_tok
        if quant is None and (card != host or card != contiguous):
            raise AssertionError(
                f"small model paged: card {card} / CPU {host} / contiguous "
                f"{contiguous}")
        paged_info[quant or "float32"] = {
            "prefix_hits": hits, "card_vs_cpu_equal_tokens": share,
            "counters": got_counts}
    say(phase="small_e2e", tokens_identical=True, logits_max_abs_err=logit_err,
        logits_tolerance=1e-3, batcher_matches_generate=True,
        paged_batcher=paged_info, counters=on_card)


MOE_FFN_VALUES = ("aligned", "gather", "gather_combine")


def set_moe_ffn(model, moe_ffn):
    """Point every MoE layer of ``model`` at one expert-FFN kernel."""
    from d9d_tpu_torch.nn.moe import MoELayer

    for m in model.modules():
        if isinstance(m, MoELayer):
            m.moe_ffn = moe_ffn


def phase_small_e2e_moe():
    """Serving a narrow fp32 Qwen3-MoE model on the card (flash, decode and
    MoE kernels) against the same weights on the CPU (their plain versions),
    once for each moe_ffn value: greedy tokens of ``generate`` identical,
    teacher-forced logits within tolerance, the contiguous batcher's streams
    identical, the paged batcher's too with fp32 pools (and equal to the
    contiguous ones) and with int8 pools as a share of equal tokens, prefix
    hits on both sides alike."""
    from d9d_tpu_torch.loop import ContinuousBatcher, generate
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
    from d9d_tpu_torch.nn.decode_flags import continuation_chunk

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3MoeConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, moe_intermediate_size=128,
        num_experts=8, num_experts_per_tok=2,
    )
    layers, dml = cfg.num_layers, 96
    gpu = Qwen3MoeCausalLM(cfg, decode_max_length=dml, dtype=torch.float32,
                           seed=7)
    cpu = Qwen3MoeCausalLM(cfg, decode_max_length=dml, dtype=torch.float32,
                           device="cpu", seed=7)
    cpu.load_state_dict(gpu.state_dict())

    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 1024, (3, 40), generator=g)
    lengths = torch.tensor([40, 17, 29])
    kw = dict(max_new_tokens=12, prompt_lengths=lengths, prefill_chunk_size=16)
    pos = torch.clamp(torch.arange(40)[None, :] - (40 - lengths)[:, None],
                      min=0)
    valid = (torch.arange(dml)[None, :] >= (40 - lengths)[:, None])[
        :, None, None, :]

    def forced(model):
        """Teacher-forced logits: prefill, a continuation chunk, a step."""
        dev = model.device
        cache = model.init_cache(3)
        i, p, m = ids.to(dev), pos.to(dev).to(torch.int32), valid.to(dev)
        a = model.logits_last(i[:, :24], p[:, :24], mask=m, cache=cache)
        with continuation_chunk():
            b = model.logits_last(i[:, 24:39], p[:, 24:39], mask=m,
                                  cache=cache)
        c = model.logits_last(i[:, 39:], p[:, 39:], mask=m, cache=cache)
        return torch.cat([a, b, c], dim=1).cpu()

    prompts = [ids[0, :n].tolist() for n in (5, 9, 3, 12, 7)]
    budgets = [6, 10, 4, 8, 12]

    def serve(model, **bkw):
        b = ContinuousBatcher(model, batch_size=2, chunk_size=4, **bkw)
        rids = [b.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        res = b.drain()
        if b._kv is not None:
            b._kv.check_invariants()
        return [res[r] for r in rids], b

    out = {}
    for moe_ffn in MOE_FFN_VALUES:
        set_moe_ffn(gpu, moe_ffn)
        set_moe_ffn(cpu, moe_ffn)
        name = f"moe_ffn_{moe_ffn}"
        reset_counters(gpu)
        got = generate(gpu, ids, **kw)
        torch.cuda.synchronize()
        on_card = read_counters(gpu)
        # chunk 0 on flash_fwd, 2 continuation chunks and 11 steps on
        # flash_decode; every model call through both MoE layers
        want_counts = counts(flash_fwd=layers, flash_decode=layers * 13,
                             **{name: layers * 14})
        if on_card != want_counts:
            raise AssertionError(
                f"small MoE {moe_ffn}: counters {on_card}, expected "
                f"{want_counts}")
        want = generate(cpu, ids, **kw)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(
                f"small MoE {moe_ffn}: greedy tokens differ\n{got.cpu()}\n"
                f"{want}")
        logit_err = max_err(forced(gpu), forced(cpu))
        if logit_err > 1e-3:
            raise AssertionError(
                f"small MoE {moe_ffn}: logits differ by {logit_err}")

        reset_counters(gpu)
        card, b = serve(gpu)
        torch.cuda.synchronize()
        got_counts = read_counters(gpu)
        steps = b.stats.device_steps
        if got_counts != counts(flash_decode=steps * layers,
                                **{name: steps * layers}):
            raise AssertionError(
                f"small MoE {moe_ffn} batcher: counters {got_counts}")
        host, _ = serve(cpu)
        if card != host:
            raise AssertionError(
                f"small MoE {moe_ffn} batcher: card {card} / CPU {host}")
        contiguous = card

        paged_info = {}
        for quant in (None, "int8"):
            reset_counters(gpu)
            card, b = serve(gpu, page_size=4, kv_quant=quant)
            torch.cuda.synchronize()
            got_counts = read_counters(gpu)
            steps = b.stats.device_steps
            if got_counts != counts(flash_decode_paged=steps * layers,
                                    **{name: steps * layers}):
                raise AssertionError(
                    f"small MoE {moe_ffn} paged {quant}: counters "
                    f"{got_counts}")
            host, hb = serve(cpu, page_size=4, kv_quant=quant)
            hits = b._kv.prefix_hits
            if hits < 1 or hb._kv.prefix_hits != hits:
                raise AssertionError(
                    f"small MoE {moe_ffn} paged {quant}: prefix hits "
                    f"{hits}/{hb._kv.prefix_hits}")
            n_tok = sum(len(x) for x in card)
            share = sum(a == c for x, y in zip(card, host)
                        for a, c in zip(x, y)) / n_tok
            if quant is None and (card != host or card != contiguous):
                raise AssertionError(
                    f"small MoE {moe_ffn} paged: card {card} / CPU {host} / "
                    f"contiguous {contiguous}")
            paged_info[quant or "float32"] = {
                "prefix_hits": hits, "card_vs_cpu_equal_tokens": share,
                "counters": got_counts}
        out[moe_ffn] = {"tokens_identical": True,
                        "logits_max_abs_err": logit_err,
                        "batcher_identical": True, "paged_batcher": paged_info,
                        "generate_counters": on_card}
    say(phase="small_e2e_moe", logits_tolerance=1e-3, **out)


# ---------------------------------------------------------------------------
# phase 5: full width


# the serving phases' depth: half of each model's, to keep the script in
# its time beside phase 14 (per-step serving numbers at this depth are not
# comparable to full-depth runs)
SERVE_DENSE_LAYERS = 18  # of Qwen3-8B's 36
SERVE_MOE_LAYERS = 24    # of Qwen3-30B-A3B's 48


def phase_full_width():
    import dataclasses
    import random

    from d9d_tpu_torch.loop import ContinuousBatcher, generate
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig

    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(),
                              num_layers=SERVE_DENSE_LAYERS)
    layers = cfg.num_layers
    dml = 4096
    t0 = time.perf_counter()
    model = Qwen3DenseCausalLM(cfg, decode_max_length=dml,
                               dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(phase="full_width", model="qwen3_8b", layers=layers,
        layers_reduced_from=36, params=n_params,
        init_seconds=round(time.perf_counter() - t0, 2),
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
    return launches, model


# paged serving traffic: 12 requests, 6 of them sharing a 256-token prefix
# (a system prompt). The first shared request and 6 others arrive first; the
# other 5 shared ones arrive once the first one's prompt has been fed (its
# prefix pages are then hit-eligible), so they hit the prefix cache.
PAGED_SHARED_PREFIX = 256
PAGED_LATE = 5


# the same shape of traffic with shorter prompts and budgets, for the MoE
# model, whose decode step takes ~2.5x the dense one's: unrelated prompts of
# at most 64 tokens, late shared tails of at most 32, 8 to 16 new tokens
# (the dense and MoE traffic were cut to keep the script in its time)
MOE_PAGED_TRAFFIC = dict(unrelated=(16, 64), late_tail=(16, 32),
                         new=(8, 16))


def paged_requests(vocab, seed=9, unrelated=(16, 256), late_tail=(16, 128),
                   new=(16, 32)):
    """``[(prompt, max_new_tokens)]`` in arrival order: the shared prefix's
    first request, 6 unrelated ones, then the 5 late shared ones. The
    ranges bound the unrelated prompts' lengths, the late shared prompts'
    tails and the budgets."""
    import random

    rnd = random.Random(seed)
    shared = [rnd.randrange(vocab) for _ in range(PAGED_SHARED_PREFIX)]

    def tail(lo, hi):
        return [rnd.randrange(vocab) for _ in range(rnd.randint(lo, hi))]

    reqs = [(shared + tail(16, 16), rnd.randint(*new))]
    reqs += [(tail(*unrelated), rnd.randint(*new)) for _ in range(6)]
    reqs += [(shared + tail(*late_tail), rnd.randint(*new))
             for _ in range(PAGED_LATE)]
    return reqs


def phase_full_width_paged(model, phase="full_width_paged", moe_kernel=None):
    """A full-width model (Qwen3-8B at SERVE_DENSE_LAYERS; Qwen3-30B-A3B at
    SERVE_MOE_LAYERS with
    ``moe_kernel``, the wrapper its MoE layers run, on the shorter
    ``MOE_PAGED_TRAFFIC``) through the paged ContinuousBatcher (page 16,
    prefix cache on, default pool: every slot at full length + the garbage
    page), once with bf16 pools and once with int8 pools, and the
    contiguous batcher on the same requests and weights for the
    greedy-token share. Each batcher and its cache are freed before the
    next."""
    cfg = model.config
    layers = cfg.num_layers
    reqs = paged_requests(cfg.vocab_size,
                          **({} if moe_kernel is None else MOE_PAGED_TRAFFIC))

    def expect(decode_kernel, steps):
        """Counters of ``steps`` device steps: the decode kernel once per
        layer, the expert FFN once per MoE layer."""
        launches = {decode_kernel: steps * layers}
        if moe_kernel is not None:
            launches[moe_kernel] = steps * (layers - len(cfg.mlp_only_layers))
        return counts(**launches)

    def serve(**kw):
        from d9d_tpu_torch.loop import ContinuousBatcher

        reset_counters(model)
        torch.cuda.reset_peak_memory_stats()
        batcher = ContinuousBatcher(model, batch_size=8, chunk_size=8, **kw)
        early = len(reqs) - PAGED_LATE
        rids = [batcher.submit(p, max_new_tokens=n) for p, n in reqs[:early]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the first request's prompt is fed in these chunks
        for _ in range(-(-len(reqs[0][0]) // 8)):
            batcher.step_chunk()
        rids += [batcher.submit(p, max_new_tokens=n) for p, n in reqs[early:]]
        outputs = batcher.drain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        streams = [outputs[r] for r in rids]
        for toks, (_p, n) in zip(streams, reqs):
            if len(toks) != n or min(toks) < 0 or max(toks) >= cfg.vocab_size:
                raise AssertionError(
                    f"paged batcher {kw}: {len(toks)} of {n} tokens")
        stats = batcher.stats
        if stats.readbacks != stats.chunks:
            raise AssertionError(f"paged batcher {kw}: readbacks {stats}")
        return batcher, streams, seconds, read_counters(model)

    def report(entry, batcher, seconds, got, **extra):
        stats = batcher.stats
        say(phase=phase, entry=entry, batch_size=8,
            chunk_size=8, requests=len(reqs),
            prompt_tokens=sum(len(p) for p, _ in reqs),
            emitted_tokens=stats.emitted_tokens, seconds=seconds,
            emitted_tokens_per_s=stats.emitted_tokens / seconds,
            ms_per_device_step=1e3 * seconds / stats.device_steps,
            device_steps=stats.device_steps,
            dispatches_per_1k_tokens=stats.dispatches_per_1k_tokens,
            readbacks_per_1k_tokens=stats.readbacks_per_1k_tokens,
            slot_utilization=stats.slot_utilization,
            hbm_bytes_per_request=batcher.hbm_bytes_per_request(),
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            counters=got, **extra)

    contiguous, want, seconds, got = serve()
    if got != expect("flash_decode", contiguous.stats.device_steps):
        raise AssertionError(f"contiguous batcher: counters {got}")
    report("ContinuousBatcher", contiguous, seconds, got,
           kv_bytes_resident=contiguous._kv_bytes_static)
    del contiguous
    torch.cuda.empty_cache()

    launches = dict.fromkeys(KERNEL_NAMES + ("plain_calls", "eager_calls",
                                             "moe_readbacks"), 0)
    n_tokens = sum(len(t) for t in want)
    for quant in (None, "int8"):
        batcher, streams, seconds, got = serve(page_size=16,
                                               prefix_cache=True,
                                               kv_quant=quant)
        steps = batcher.stats.device_steps
        if got != expect("flash_decode_paged", steps):
            raise AssertionError(f"paged batcher {quant}: counters {got}")
        kv = batcher._kv
        kv.check_invariants()
        if kv.prefix_hits < 1 or kv.pages_in_use != len(kv._entries):
            raise AssertionError(
                f"paged batcher {quant}: {kv.prefix_hits} prefix hits, "
                f"{kv.pages_in_use} pages in use after the drain")
        same = sum(a == b for s, w in zip(streams, want)
                   for a, b in zip(s, w))
        report("ContinuousBatcher(page_size=16, prefix_cache=True"
               + (", kv_quant='int8')" if quant else ")"),
               batcher, seconds, got,
               prefix_hit_rate=batcher.prefix_hit_rate(),
               prefix_hits=kv.prefix_hits,
               prefix_hit_tokens=kv.prefix_hit_tokens,
               num_pages=kv.num_pages, page_bytes=batcher._page_bytes,
               peak_pages_in_use=kv.peak_pages_in_use,
               pages_in_use_after_drain=kv.pages_in_use,
               greedy_tokens_equal_to_contiguous=same / n_tokens,
               first_diverging_request=next(
                   (i for i, (s, w) in enumerate(zip(streams, want))
                    if s != w), None))
        for name in launches:
            launches[name] += got[name]
        del batcher
        torch.cuda.empty_cache()
    return launches


def phase_full_width_moe():
    """Qwen3-30B-A3B at full width and SERVE_MOE_LAYERS of its 48 layers,
    random bf16 weights
    drawn on the card (an fp32 copy would need 122 GB): ``generate`` on a
    ragged batch of 4 with chunked prefill once per moe_ffn value (B5 and
    B6 greedy tokens equal; B7's share of equal tokens read), then the
    gather+combine kernel through the contiguous batcher and the paged one
    with bf16 and int8 pools, and a profiled decode step."""
    import dataclasses

    from d9d_tpu_torch.loop import generate
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig

    cfg = dataclasses.replace(Qwen3MoeConfig.qwen3_30b_a3b(),
                              num_layers=SERVE_MOE_LAYERS)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    model = Qwen3MoeCausalLM(cfg, decode_max_length=4096,
                             dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    say(phase="full_width_moe", model="qwen3_30b_a3b", layers=layers,
        layers_reduced_from=48,
        params=sum(p.numel() for p in model.parameters()),
        init_seconds=round(time.perf_counter() - t0, 2),
        weight_bytes=weight_bytes)
    torch.cuda.reset_peak_memory_stats()

    g = torch.Generator().manual_seed(11)
    p_len, new, chunk = 1024, 32, 512
    ids = torch.randint(0, cfg.vocab_size, (4, p_len), generator=g)
    lengths = torch.tensor([1024, 700, 900, 513])
    kw = dict(prompt_lengths=lengths, prefill_chunk_size=chunk)
    launches = dict.fromkeys(KERNEL_NAMES + ("plain_calls", "eager_calls",
                                             "moe_readbacks"), 0)
    streams = {}
    for moe_ffn in MOE_FFN_VALUES:
        set_moe_ffn(model, moe_ffn)
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
        # per generate call: chunk 0 on flash_fwd, chunk 1 and every decode
        # step on flash_decode, each layer's MoE block on every model call
        want = counts(flash_fwd=2 * layers,
                      flash_decode=2 * layers + (new - 1) * layers,
                      **{f"moe_ffn_{moe_ffn}": 2 * 2 * layers
                         + (new - 1) * layers})
        if got != want:
            raise AssertionError(
                f"MoE generate {moe_ffn}: counters {got}, expected {want}")
        out_c = out.cpu()
        if out_c.shape != (4, new) or int(out_c.min()) < 0 \
                or int(out_c.max()) >= cfg.vocab_size:
            raise AssertionError(f"MoE generate {moe_ffn}: malformed output")
        if not torch.equal(out_c[:, 0], first.cpu()[:, 0]):
            raise AssertionError(f"MoE generate {moe_ffn}: prefills disagree")
        streams[moe_ffn] = out_c
        for key in launches:
            launches[key] += got[key]
        decode_s = max(total_s - prefill_s, 1e-9)
        say(phase="full_width_moe", entry="generate", moe_ffn=moe_ffn,
            batch=4, prompt_tokens=int(lengths.sum()), new_tokens=4 * new,
            prefill_seconds=prefill_s,
            prefill_tokens_per_s=float(lengths.sum()) / prefill_s,
            decode_seconds=decode_s,
            decode_tokens_per_s=4 * (new - 1) / decode_s,
            ms_per_decode_step=1e3 * decode_s / (new - 1), counters=got,
            peak_memory_bytes=torch.cuda.max_memory_allocated())
    # B6 is B5's arithmetic on gathered rows: the same bits, the same tokens
    if not torch.equal(streams["gather"], streams["aligned"]):
        raise AssertionError(
            f"MoE generate: gather tokens {streams['gather']} differ from "
            f"aligned {streams['aligned']}")
    say(phase="full_width_moe", entry="generate",
        gather_equals_aligned=True,
        gather_combine_equal_token_share=float(
            (streams["gather_combine"] == streams["aligned"]).float().mean()))

    set_moe_ffn(model, "gather_combine")
    for key, n in phase_full_width_paged(
            model, phase="full_width_moe_paged",
            moe_kernel="moe_ffn_gather_combine").items():
        launches[key] += n
    say(phase="profile", model="qwen3_30b_a3b", moe_ffn="gather_combine",
        **profile_decode_steps(model, random_tokens=True))
    return launches


def profile_decode_steps(model, batch=8, steps=4, random_tokens=False):
    """Where a full-width decode step spends its time: ``steps`` single-token
    steps of a batch-8 cache at ~1k tokens under ``torch.profiler`` (a
    window opened by a marker kernel, kernels counted in whole launches a
    step: :func:`_profile_kernels`). Reports
    the wall time per step (taken without the profiler), the device's busy
    time per step (sum of kernel times) and the share of the step the device
    sat idle; null where the
    profiler recorded no device activity. Also the host syncs of the steps
    (CUDA sync debug mode's warnings) and the MoE group-size readbacks,
    both 0 on a forward with no readback, and the MoE kernels' device time.
    ``random_tokens``: each row a different seeded token (a MoE model then
    routes the rows apart), else token 0 everywhere. Runs after the
    counters of the main path were read."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from d9d_tpu_torch.ops.moe import group_sizes_on_host

    cache = model.init_cache(batch, per_row=True)
    cache.index.fill_(1000)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=model.device)
    if random_tokens:
        g = torch.Generator().manual_seed(17)
        tok = torch.randint(0, model.config.vocab_size, (batch, 1),
                            generator=g).to(model.device)
    pos = torch.full((batch, 1), 1000, dtype=torch.int32, device=model.device)

    def run(sync=True):
        for _ in range(steps):
            model.logits_last(tok, pos, cache=cache)
        if sync:
            torch.cuda.synchronize()

    run()  # warm
    cache.index.fill_(1000)
    t0 = time.perf_counter()
    run()  # the wall time is taken without the profiler's overhead
    wall = time.perf_counter() - t0
    cache.index.fill_(1000)
    readbacks = group_sizes_on_host.readbacks
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(sync=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    readbacks = group_sizes_on_host.readbacks - readbacks
    # the mode's own notice ("... is a prototype feature ...") is no sync
    syncs = [str(w.message)[:120] for w in caught
             if "called a synchronizing" in str(w.message)]

    def window():
        cache.index.fill_(1000)
        run()

    # device rows only: an operator row repeats its kernels' device time;
    # each kernel counted in whole launches a step, its time as its mean
    # time a recorded launch times those launches
    prof, kernels = _profile_kernels(
        window, steps, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith("aten::")),
                      key=lambda e: -e.count)
    per_step = {e.key: _launches_per_call(e, steps) for e in kernels}

    def ms_per_step(e):
        return e.self_device_time_total / 1e3 / e.count * per_step[e.key]

    busy_ms = sum(ms_per_step(e) for e in kernels)
    top = sorted(kernels, key=lambda e: -ms_per_step(e))
    out = {
        "what": f"{steps} decode steps, batch {batch}, cache at 1000 tokens",
        "wall_ms_per_step": 1e3 * wall / steps,
        "host_syncs_per_step": len(syncs) / steps,
        "host_sync_messages": sorted(set(syncs))[:4],
        "moe_readbacks_per_step": readbacks / steps,
        "device_busy_ms_per_step": None, "device_idle_share": None,
        "device_kernels_per_step": None, "top_device_ops": None,
        "top_host_ops_by_calls": [
            {"name": e.key, "calls_per_step": e.count / steps}
            for e in host_ops[:12]],
    }
    if busy_ms > 0:
        out.update(
            device_busy_ms_per_step=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / (1e3 * wall / steps)),
            device_kernels_per_step=sum(per_step.values()),
            # the decode kernels of a step by name: one per layer, and no
            # split combine, is the one-launch contract of the wrappers
            decode_kernels_per_step={
                e.key[:72]: per_step[e.key] for e in kernels
                if DECODE_KERNEL_TAG in e.key},
            # the expert-FFN kernels (none in a dense model)
            moe_kernels_per_step={
                e.key[:72]: {"calls": per_step[e.key], "ms": ms_per_step(e)}
                for e in kernels if MOE_KERNEL_TAG in e.key},
            moe_device_ms_per_step=sum(
                ms_per_step(e) for e in kernels if MOE_KERNEL_TAG in e.key),
            top_device_ops=[
                {"name": e.key[:60], "ms_per_step": ms_per_step(e),
                 "calls_per_step": per_step[e.key]}
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

        def __init__(self, cfg, dtype, fused_bwd, state=None, seed=0,
                     param_dtype=torch.float32):
            self.cfg, self.dtype, self.fused_bwd = cfg, dtype, fused_bwd
            self.state, self.seed = state, seed
            self.param_dtype = param_dtype

        def build_module(self, ctx):
            model = Qwen3DenseCausalLM(
                self.cfg, build_sdpa_backend(
                    SdpaFlashConfig(fused_bwd=self.fused_bwd)),
                dtype=self.dtype, param_dtype=self.param_dtype,
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


def profile_train_step(trainer, raw_batch, kernel_tag=None):
    """Where a full-width train step spends its time: one
    ``Trainer.run_step`` under ``torch.profiler`` (after the main path's
    counters were read), and one without it for the wall time.
    ``kernel_tag``: also list every kernel whose name holds it, in or out
    of the top ten."""
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
        if kernel_tag is not None:
            out["tagged_device_ops"] = {
                "tag": kernel_tag,
                "ms_per_step": sum(e.self_device_time_total for e in top
                                   if kernel_tag in e.key) / 1e3,
                "ops": [{"name": e.key[:60],
                         "ms_per_step": e.self_device_time_total / 1e3,
                         "calls_per_step": e.count}
                        for e in top if kernel_tag in e.key]}
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


# ---------------------------------------------------------------------------
# Qwen3-MoE training: small end-to-end agreement, then full width


def _moe_provider(cfg, dtype, moe_ffn, state=None, seed=0,
                  param_dtype=torch.float32):
    from d9d_tpu_torch.loop import ModelProvider
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM

    class Provider(ModelProvider):
        """The MoE model on the context's device; weights from ``state``
        when given, else drawn from ``seed`` on that device."""

        def build_module(self, ctx):
            model = Qwen3MoeCausalLM(
                cfg, moe_ffn=moe_ffn, dtype=dtype, param_dtype=param_dtype,
                device=ctx.device, seed=None if state is not None else seed)
            if state is not None:
                model.load_state_dict(state)
            return model

    return Provider()


def phase_small_e2e_train_moe():
    """3 Trainer steps of a narrow fp32 Qwen3-MoE model on the card (flash
    and MoE kernels) and on the CPU (their plain versions), from the same
    weights and batches, once for each moe_ffn value."""
    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    _, schedule = _train_parts()
    cfg = Qwen3MoeConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, moe_intermediate_size=128,
        num_experts=8, num_experts_per_tok=2,
    )
    state = Qwen3MoeCausalLM(cfg, dtype=torch.float32,
                             param_dtype=torch.float32, device="cpu",
                             seed=7).state_dict()
    data = _Batches(1024, 3, 4, 128, seed=21, loss_mask=True)

    def run(device, moe_ffn):
        trainer = Trainer(
            ctx=MeshParameters().build([device]),
            config=TrainerConfig(global_batch_size=4, microbatch_size=2,
                                 seq_len=128, total_steps=3, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=_moe_provider(cfg, torch.float32, moe_ffn,
                                         state=state),
            dataset_provider=data, task=CausalLMTask(),
            optimizer_provider=AdamWProvider(weight_decay=0.1),
            learning_rate=schedule(1e-3, 3))
        reset_counters(trainer.module)
        hist = trainer.train()
        torch.cuda.synchronize()
        return hist, read_counters(trainer.module)

    tol = 1e-4  # fp32 on both sides; products and sums in other orders
    keys = ("loss", "grad_norm", "task/moe_load_max_frac")
    host, _ = run("cpu", "aligned")
    out = {}
    for moe_ffn in ("aligned", "gather", "gather_combine"):
        card, on_card = run("cuda", moe_ffn)
        # 2 layers x 2 microbatches x 3 steps; the forward runs twice (remat)
        want = counts(flash_fwd=24, flash_bwd_dq=12, flash_bwd_dkv=12,
                      moe_readbacks=12, **{f"moe_ffn_{moe_ffn}": 24})
        if on_card != want:
            raise AssertionError(
                f"small MoE train {moe_ffn}: counters {on_card}, "
                f"expected {want}")
        rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                      for a, b in zip(card, host)) for k in keys}
        if max(rel.values()) > tol:
            raise AssertionError(
                f"small MoE train {moe_ffn}: card vs CPU {rel} "
                f"(tolerance {tol})")
        out[moe_ffn] = {"card": [{k: h[k] for k in ("step",) + keys}
                                 for h in card],
                        "max_rel_diff_card_vs_cpu": rel, "counters": on_card}
    say(phase="small_e2e_train_moe", steps=3, tolerance=tol,
        cpu=[{k: h[k] for k in ("step",) + keys} for h in host], **out)


def phase_full_width_train_moe():
    """Qwen3-30B-A3B widths at 4 of 48 layers through Trainer.train: 6 steps
    with the aligned expert-FFN kernel, a profiled step, then 2 steps each
    of fresh trainers (same seed) with the gather and gather+combine
    kernels."""
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
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeConfig

    _, schedule = _train_parts()
    layers = 4  # of 48: fp32 params + grads + two Adam moments, 16 B/param
    cfg = dataclasses.replace(Qwen3MoeConfig.qwen3_30b_a3b(),
                              num_layers=layers)
    gbs, mbs, seq, steps = 4, 2, 2048, 6
    data = _Batches(cfg.vocab_size, steps + 2, gbs, seq, seed=5)
    per_call = layers * (gbs // mbs)  # layer calls per step

    def trainer_for(moe_ffn, total):
        return Trainer(
            ctx=MeshParameters().build(),
            config=TrainerConfig(global_batch_size=gbs, microbatch_size=mbs,
                                 seq_len=seq, total_steps=total, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=_moe_provider(cfg, torch.bfloat16, moe_ffn, seed=0),
            dataset_provider=data, task=CausalLMTask(),
            optimizer_provider=AdamWProvider(weight_decay=0.1),
            learning_rate=schedule(3e-4, total))

    def check(tag, moe_ffn, hist, got, n_steps):
        n = per_call * n_steps
        want = counts(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n,
                      moe_readbacks=n, **{f"moe_ffn_{moe_ffn}": 2 * n})
        if got != want:
            raise AssertionError(f"{tag}: counters {got}, expected {want}")
        vals = [h[k] for h in hist
                for k in ("loss", "grad_norm", "task/moe_load_max_frac")]
        if len(hist) != n_steps or not all(map(math.isfinite, vals)):
            raise AssertionError(f"{tag}: bad history {hist}")

    def rows(hist):
        return [{"step": h["step"], "loss": h["loss"],
                 "grad_norm": h["grad_norm"],
                 "moe_load_max_frac": h["task/moe_load_max_frac"]}
                for h in hist]

    t0 = time.perf_counter()
    trainer = trainer_for("aligned", steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.module.parameters())
    experts = sum(p.numel() for n_, p in trainer.module.named_parameters()
                  if "grouped_experts" in n_)
    say(phase="full_width_train_moe", model="qwen3_30b_a3b", layers=layers,
        layers_reduced_from=48, params=n_params, expert_params=experts,
        state_bytes=16 * n_params, init_seconds=time.perf_counter() - t0,
        setup={"param_dtype": "float32", "dtype": "bfloat16",
               "remat": cfg.remat_policy, "global_batch_size": gbs,
               "microbatch_size": mbs, "seq_len": seq,
               "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
               "optimizer": "AdamW wd 0.1", "warmup_steps": 2})
    torch.cuda.reset_peak_memory_stats()
    reset_counters(trainer.module)
    hist = trainer.train()
    torch.cuda.synchronize()
    got = read_counters(trainer.module)
    check("train_moe aligned", "aligned", hist, got, steps)
    losses = [h["loss"] for h in hist]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe: loss did not fall: {losses}")
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                   for a, b in zip(hist, hist[1:])]
    ms_step = 1e3 * statistics.median(walls[1:])
    launches = dict(got)
    say(phase="full_width_train_moe", entry="Trainer.train",
        moe_ffn="aligned", steps=rows(hist), ms_per_step=ms_step,
        ms_per_step_all=[1e3 * w for w in walls],
        tokens_per_s=gbs * seq / (ms_step / 1e3),
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got,
        per_step={"moe_kernel_launches": got["moe_ffn_aligned"] / steps,
                  "moe_readbacks": got["moe_readbacks"] / steps})
    say(phase="profile", **profile_train_step(trainer, data.batches[steps],
                                              kernel_tag=MOE_KERNEL_TAG))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    tol = 1e-3  # bf16: the combine kernel rounds a token's K-sum once
    for moe_ffn in ("gather", "gather_combine"):
        trainer = trainer_for(moe_ffn, 2)
        torch.cuda.reset_peak_memory_stats()
        reset_counters(trainer.module)
        vhist = trainer.train()
        torch.cuda.synchronize()
        got = read_counters(trainer.module)
        check(f"train_moe {moe_ffn}", moe_ffn, vhist, got, 2)
        if not vhist[-1]["loss"] < vhist[0]["loss"]:
            raise AssertionError(
                f"train_moe {moe_ffn}: loss did not fall: {rows(vhist)}")
        rel = {k: abs(vhist[0][k] - hist[0][k]) / abs(hist[0][k])
               for k in ("loss", "grad_norm")}
        if max(rel.values()) > tol:
            raise AssertionError(
                f"train_moe {moe_ffn}: step 1 vs aligned {rel} "
                f"(tolerance {tol})")
        say(phase="full_width_train_moe", entry="Trainer.train",
            moe_ffn=moe_ffn, steps=rows(vhist),
            step1_vs_aligned=rel, tolerance=tol,
            ms_per_step_all=[1e3 * vhist[0]["wall_s"],
                             1e3 * (vhist[1]["wall_s"] - vhist[0]["wall_s"])],
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            counters=got)
        for name, n in got.items():
            launches[name] += n
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training with bf16 parameters (StochasticAdamW): small end-to-end
# agreement, then full width


def _stochastic_adamw_provider(**kw):
    from d9d_tpu_torch.loop import (
        OptimizerProvider,
        StochasticAdamWConfig,
        build_optimizer,
    )

    class Provider(OptimizerProvider):
        def build(self, params, learning_rate):
            return build_optimizer(StochasticAdamWConfig(**kw), params,
                                   learning_rate)

    return Provider()


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at the larger magnitude."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _state_bytes(trainer):
    """Parameters, optimizer moments and fp32 gradient accumulators (one
    fp32 value per trainable parameter during the step)."""
    params = [p for p in trainer.module.parameters() if p.requires_grad]
    opt = trainer.optimizer
    return {"params": sum(p.numel() * p.element_size() for p in params),
            "moments": sum(m.numel() * m.element_size()
                           for m in opt.mu + opt.nu),
            "grad_accumulators": sum(4 * p.numel() for p in params)}


def _n_bf16(module):
    return sum(p.dtype == torch.bfloat16 for p in module.parameters())


# Card vs CPU, one StochasticAdamW step from the same bf16 parameters, fp32
# moments and fp32 gradients. The fp32 arithmetic is the same elementwise
# chain on both sides; it may differ where a compiler contracts a multiply
# and an add into one FMA, by an fp32 ulp of the larger term, so moments are
# held to rtol 1e-6 of themselves plus 1e-6 of the leaf's largest value (a
# moment that cancels to near 0 keeps the error of its terms). Both sides
# round the new fp32 parameter with the same bits, so a parameter differs
# only where the fp32 values straddle a rounding threshold: at most one bf16
# ulp; 2 are allowed.
OPT_MOMENT_RTOL = 1e-6
OPT_PARAM_ULPS = 2
# Card vs CPU, 3 Trainer steps of a narrow model with bf16 parameters (fp32
# compute): the fp32 tolerance of the fp32 small train (products and sums in
# other orders); the roundings use the same bits on both sides.
BF16_TRAIN_TOL = 1e-4


def phase_small_e2e_train_bf16():
    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.loop import CausalLMTask, Trainer, TrainerConfig
    from d9d_tpu_torch.models.qwen3 import (
        Qwen3DenseCausalLM,
        Qwen3DenseConfig,
        Qwen3MoeCausalLM,
        Qwen3MoeConfig,
    )
    from d9d_tpu_torch.optim import StochasticAdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    shapes = [((4096, 1024), torch.bfloat16), ((1000003,), torch.bfloat16),
              ((128,), torch.float32)]
    p0 = [torch.randn(s, generator=gen).to(dt) for s, dt in shapes]
    mu = [0.01 * torch.randn(s, generator=gen) for s, _ in shapes]
    nu = [1e-4 * torch.rand(s, generator=gen) for s, _ in shapes]
    grads = [0.01 * torch.randn(s, generator=gen) for s, _ in shapes]
    out = {}
    for dev in ("cuda", "cpu"):
        params = [torch.nn.Parameter(p.to(dev)) for p in p0]
        opt = StochasticAdamW(params, 1e-3, weight_decay=0.1, seed=5)
        opt.load_state_dict({"count": 3, "seed": 5,
                             "mu": [m.to(dev) for m in mu],
                             "nu": [v.to(dev) for v in nu]})
        reset_counters()
        opt.step([g.to(dev) for g in grads])
        torch.cuda.synchronize()
        out[dev] = (params, opt, read_counters())
    (cp, copt, ccount), (hp, hopt, _) = out["cuda"], out["cpu"]
    if ccount != counts(stochastic_round=2):
        raise AssertionError(f"optimizer step: counters {ccount}")
    moment_use = 0.0
    for a, b in zip(copt.mu + copt.nu, hopt.mu + hopt.nu):
        a, b = a.cpu().double(), b.double()
        allowed = OPT_MOMENT_RTOL * (b.abs() + b.abs().max())
        moment_use = max(moment_use, float(((a - b).abs() / allowed).max()))
    ulps = [float(bf16_ulps(a.detach().cpu().float(), b.detach().float())
                  .max()) for a, b in zip(cp, hp)]
    bitwise = [bool(torch.equal(a.detach().cpu(), b.detach()))
               for a, b in zip(cp, hp)]
    if moment_use > 1.0 or max(ulps) > OPT_PARAM_ULPS:
        raise AssertionError(
            f"optimizer step card vs CPU: moments use {moment_use} of rtol "
            f"{OPT_MOMENT_RTOL}, parameters {ulps} bf16 ulps")
    say(phase="small_e2e_optimizer", optimizer="StochasticAdamW",
        shapes=[[list(s), str(dt).split(".")[-1]] for s, dt in shapes],
        moment_tolerance_use=moment_use, param_max_bf16_ulps=ulps,
        param_bitwise_equal=bitwise, counters=ccount)

    Provider, schedule = _train_parts()
    dense = Qwen3DenseConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512)
    moe = Qwen3MoeConfig(
        vocab_ranges=(("default", 1024),), hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, moe_intermediate_size=128,
        num_experts=8, num_experts_per_tok=2)
    data = _Batches(1024, 3, 4, 128, seed=21, loss_mask=True)
    keys = ("loss", "grad_norm")
    for kind, cfg in (("dense", dense), ("moe", moe)):
        cls = Qwen3DenseCausalLM if kind == "dense" else Qwen3MoeCausalLM
        state = cls(cfg, dtype=torch.float32, param_dtype=torch.bfloat16,
                    device="cpu", seed=7).state_dict()

        def run(device):
            provider = (
                Provider(cfg, torch.float32, False, state=state,
                         param_dtype=torch.bfloat16) if kind == "dense" else
                _moe_provider(cfg, torch.float32, "aligned", state=state,
                              param_dtype=torch.bfloat16))
            trainer = Trainer(
                ctx=MeshParameters().build([device]),
                config=TrainerConfig(global_batch_size=4, microbatch_size=2,
                                     seq_len=128, total_steps=3, log_every=1,
                                     max_grad_norm=1.0),
                model_provider=provider, dataset_provider=data,
                task=CausalLMTask(),
                optimizer_provider=_stochastic_adamw_provider(
                    weight_decay=0.1),
                learning_rate=schedule(1e-3, 3))
            reset_counters(trainer.module)
            hist = trainer.train()
            torch.cuda.synchronize()
            return hist, read_counters(trainer.module), _n_bf16(trainer.module)

        card, on_card, n_bf16 = run("cuda")
        host, _, _ = run("cpu")
        # 2 layers x 2 microbatches x 3 steps; one rounding per bf16
        # parameter per step
        extra = ({} if kind == "dense" else
                 {"moe_readbacks": 12, "moe_ffn_aligned": 24})
        want = counts(flash_fwd=24, flash_bwd_dq=12, flash_bwd_dkv=12,
                      stochastic_round=3 * n_bf16, **extra)
        if on_card != want:
            raise AssertionError(
                f"small bf16 train {kind}: counters {on_card}, expected "
                f"{want}")
        rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                      for a, b in zip(card, host)) for k in keys}
        if max(rel.values()) > BF16_TRAIN_TOL:
            raise AssertionError(
                f"small bf16 train {kind}: card vs CPU {rel} (tolerance "
                f"{BF16_TRAIN_TOL})")
        say(phase="small_e2e_train_bf16", model=kind, steps=3,
            param_dtype="bfloat16", dtype="float32",
            optimizer="StochasticAdamW wd 0.1", bf16_parameters=n_bf16,
            card=[{k: h[k] for k in ("step",) + keys} for h in card],
            cpu=[{k: h[k] for k in ("step",) + keys} for h in host],
            max_rel_diff_card_vs_cpu=rel, tolerance=BF16_TRAIN_TOL,
            counters=on_card)


def phase_full_width_train_bf16():
    """Qwen3-8B widths at 8 of 36 layers with bf16 parameters (q/k norms
    bf16, layer norms fp32, as in JAX) under StochasticAdamW: 6 steps, a
    profiled step, then 2 steps of a fresh trainer with bf16 moments; then
    Qwen3-30B-A3B widths at 4 of 48 layers, 2 steps (B5 on bf16 expert
    stacks)."""
    import dataclasses
    import gc
    import math
    import statistics

    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.loop import CausalLMTask, Trainer, TrainerConfig
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseConfig, Qwen3MoeConfig

    Provider, schedule = _train_parts()
    gbs, mbs, seq, steps = 4, 2, 2048, 6

    def trainer_for(cfg, provider, total, **opt):
        return Trainer(
            ctx=MeshParameters().build(),
            config=TrainerConfig(global_batch_size=gbs, microbatch_size=mbs,
                                 seq_len=seq, total_steps=total, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=provider, dataset_provider=data,
            task=CausalLMTask(),
            optimizer_provider=_stochastic_adamw_provider(**opt),
            learning_rate=schedule(3e-4, total))

    def run(trainer, tag, n_steps, roundings, **launches):
        torch.cuda.reset_peak_memory_stats()
        reset_counters(trainer.module)
        hist = trainer.train()
        torch.cuda.synchronize()
        got = read_counters(trainer.module)
        want = counts(stochastic_round=roundings * n_steps, **{
            k: v * n_steps for k, v in launches.items()})
        if got != want:
            raise AssertionError(f"{tag}: counters {got}, expected {want}")
        vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
        if len(hist) != n_steps or not all(map(math.isfinite, vals)):
            raise AssertionError(f"{tag}: bad history {hist}")
        walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                       for a, b in zip(hist, hist[1:])]
        return hist, got, walls

    def rows(hist):
        return [{"step": h["step"], "loss": h["loss"],
                 "grad_norm": h["grad_norm"]} for h in hist]

    layers = 8  # of 36, as the fp32 phase
    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(), num_layers=layers)
    data = _Batches(cfg.vocab_size, steps + 2, gbs, seq, seed=5)
    per_call = layers * (gbs // mbs)
    dense_launches = dict(flash_fwd=2 * per_call, flash_bwd_dq=per_call,
                          flash_bwd_dkv=per_call)

    def dense_provider():
        return Provider(cfg, torch.bfloat16, False, seed=0,
                        param_dtype=torch.bfloat16)

    t0 = time.perf_counter()
    trainer = trainer_for(cfg, dense_provider(), steps)
    torch.cuda.synchronize()
    n_bf16 = _n_bf16(trainer.module)
    say(phase="full_width_train_bf16", model="qwen3_8b", layers=layers,
        layers_reduced_from=36,
        params=sum(p.numel() for p in trainer.module.parameters()),
        bf16_parameter_tensors=n_bf16, state_bytes=_state_bytes(trainer),
        init_seconds=time.perf_counter() - t0,
        setup={"param_dtype": "bfloat16 (layer norms float32)",
               "dtype": "bfloat16", "remat": cfg.remat_policy,
               "global_batch_size": gbs, "microbatch_size": mbs,
               "seq_len": seq, "optimizer": "StochasticAdamW defaults",
               "warmup_steps": 2})
    hist, got, walls = run(trainer, "train bf16", steps, n_bf16,
                           **dense_launches)
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"train bf16: loss did not fall: {rows(hist)}")
    ms_step = 1e3 * statistics.median(walls[1:])
    launches = dict(got)
    say(phase="full_width_train_bf16", entry="Trainer.train",
        moment_dtype="float32", steps=rows(hist), ms_per_step=ms_step,
        ms_per_step_all=[1e3 * w for w in walls],
        tokens_per_s=gbs * seq / (ms_step / 1e3),
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got,
        per_step={"stochastic_round_launches": got["stochastic_round"] / steps,
                  "plain_calls": got["plain_calls"]})
    say(phase="profile", **profile_train_step(trainer, data.batches[steps]))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = trainer_for(cfg, dense_provider(), 2, moment_dtype="bfloat16")
    state = _state_bytes(trainer)
    # bf16 moments for every leaf (the fp32 norms' too, as in JAX): two more
    # roundings per parameter tensor
    n_tensors = sum(1 for _ in trainer.module.parameters())
    bhist, got, bwalls = run(trainer, "train bf16 moments", 2,
                             n_bf16 + 2 * n_tensors, **dense_launches)
    step1 = {k: abs(bhist[0][k] - hist[0][k]) / abs(hist[0][k])
             for k in ("loss", "grad_norm")}
    if max(step1.values()) > 1e-5:  # same weights, nothing rounded yet
        raise AssertionError(f"train bf16 moments: step 1 {step1}")
    say(phase="full_width_train_bf16", entry="Trainer.train",
        moment_dtype="bfloat16", steps=rows(bhist), state_bytes=state,
        step1_vs_fp32_moments=step1,
        ms_per_step_all=[1e3 * w for w in bwalls],
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got,
        per_step={"stochastic_round_launches": got["stochastic_round"] / 2})
    for name, n in got.items():
        launches[name] += n
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    layers = 4  # of 48, as the fp32 MoE phase
    mcfg = dataclasses.replace(Qwen3MoeConfig.qwen3_30b_a3b(),
                               num_layers=layers)
    per_call = layers * (gbs // mbs)
    t0 = time.perf_counter()
    trainer = trainer_for(mcfg, _moe_provider(
        mcfg, torch.bfloat16, "aligned", seed=0,
        param_dtype=torch.bfloat16), 2)
    torch.cuda.synchronize()
    m_bf16 = _n_bf16(trainer.module)
    state = _state_bytes(trainer)
    init_s = time.perf_counter() - t0
    mhist, got, mwalls = run(
        trainer, "train_moe bf16", 2, m_bf16, flash_fwd=2 * per_call,
        flash_bwd_dq=per_call, flash_bwd_dkv=per_call,
        moe_ffn_aligned=2 * per_call, moe_readbacks=per_call)
    say(phase="full_width_train_bf16", model="qwen3_30b_a3b", layers=layers,
        layers_reduced_from=48, entry="Trainer.train", moe_ffn="aligned",
        bf16_parameter_tensors=m_bf16, state_bytes=state,
        init_seconds=init_s, steps=rows(mhist),
        ms_per_step_all=[1e3 * w for w in mwalls],
        peak_memory_bytes=torch.cuda.max_memory_allocated(), counters=got)
    for name, n in got.items():
        launches[name] += n
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: context-parallel training on the card (ring attention, B4)
#
# Two ranks share the one card: two processes on cuda:0 over gloo (NCCL
# refuses two ranks on one device; gloo moves host memory, so the ring's
# transfers and the gradient all-reduce cross through pinned host memory).
# The run proves the kernels and the ring on the card and gives their
# times; it measures no context-parallel scaling. On a machine with N
# cards, ``python3 chip_smoke.py --cp-only nccl N`` runs this phase alone
# with one card per rank over NCCL (device tensors sent directly).

CP_RANKS = 2
CP_CHILD_TIMEOUT_S = 900
CP_LAYERS = 2        # of Qwen3-8B's 36
CP_SEQ = 16384       # global tokens per step, T_loc = 8192 per rank
CP_STEPS = 1         # cut from 3 (PR 18: 2, PR 19: 1) to keep the script in time
CP_COMPARE_LAYERS = 1
CP_COMPARE_SEQ = 4096
CP_TRAIN_TOL = 1e-4  # ring vs flash backend, fp32: sums in other orders


def _cp_parts(layers, dtype, seq, steps, seed):
    """(provider factory, trainer factory) of the phase-9 runs: Qwen3-8B
    widths at ``layers`` layers, fp32 parameters, ``dtype`` compute, full
    remat, AdamW, global batch 1 x ``seq``, weights from ``seed``."""
    import dataclasses

    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        ModelProvider,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
    from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig, SdpaRingConfig
    from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend

    _, schedule = _train_parts()
    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(), num_layers=layers)
    data = _Batches(cfg.vocab_size, steps, 1, seq, seed=seed + 1)

    class Provider(ModelProvider):
        def build_module(self, ctx):
            sdpa = (build_sdpa_backend(SdpaRingConfig(), ctx=ctx)
                    if ctx.cp_size > 1 else
                    build_sdpa_backend(SdpaFlashConfig()))
            return Qwen3DenseCausalLM(cfg, sdpa, dtype=dtype,
                                      param_dtype=torch.float32,
                                      device=ctx.device, seed=seed)

    def trainer(ctx):
        return Trainer(
            ctx=ctx,
            config=TrainerConfig(global_batch_size=1, microbatch_size=1,
                                 seq_len=seq, total_steps=steps, log_every=1,
                                 max_grad_norm=1.0),
            model_provider=Provider(), dataset_provider=data,
            task=CausalLMTask(),
            optimizer_provider=AdamWProvider(weight_decay=0.1),
            # the warmup needs 2 steps; a 1-step run takes the base rate
            learning_rate=schedule(3e-4, steps) if steps > 2 else 3e-4)

    return cfg, trainer


def _cp_compare_trainer(ctx):
    """One fp32 step at Qwen3-8B widths and CP_COMPARE_LAYERS layers:
    ring (cp ranks) against the flash backend (one process)."""
    return _cp_parts(CP_COMPARE_LAYERS, torch.float32, CP_COMPARE_SEQ, 1,
                     seed=3)[1](ctx)


def _cp_counters():
    """The kernel counters of read_counters, the ring's and the
    collectives'."""
    from d9d_tpu_torch.core.collectives import all_reduce_sum, broadcast
    from d9d_tpu_torch.ops.attention.ring import ring_attention

    return {
        **read_counters(),
        "ring_skipped_blocks": ring_attention.skipped_blocks,
        "ring_host_staged_bytes": ring_attention.host_staged_bytes,
        "ring_eager_blocks": ring_attention.eager_blocks,
        "all_reduce_calls": all_reduce_sum.calls,
        "all_reduce_seconds": all_reduce_sum.seconds,
        "all_reduce_host_staged_bytes": all_reduce_sum.host_staged_bytes,
        "broadcast_host_staged_bytes": broadcast.host_staged_bytes,
    }


def _cp_reset_counters():
    from d9d_tpu_torch.core.collectives import all_reduce_sum, broadcast
    from d9d_tpu_torch.ops.attention.ring import ring_attention

    reset_counters()
    ring_attention.skipped_blocks = 0
    ring_attention.host_staged_bytes = 0
    ring_attention.eager_blocks = 0
    all_reduce_sum.calls = 0
    all_reduce_sum.seconds = 0.0
    all_reduce_sum.host_staged_bytes = 0
    broadcast.host_staged_bytes = 0


def _cp_devices(world, backend):
    """gloo: every rank on the one card; nccl: one card per rank."""
    if backend == "nccl":
        return [f"cuda:{r}" for r in range(world)]
    return ["cuda:0"] * world


def cp_worker(rank, world, rdzv, backend):
    """One rank of phase 9 (``chip_smoke.py --cp-worker RANK WORLD
    RENDEZVOUS BACKEND``): the fp32 comparison step, then CP_STEPS steps of
    the main run; every result is a JSON line tagged with the rank."""
    import gc
    import math
    import statistics

    from d9d_tpu_torch.core import (
        MeshParameters,
        init_distributed,
        shutdown_distributed,
    )
    from d9d_tpu_torch.ops import kernel_lib

    def say_rank(**obj):
        say(rank=rank, **obj)

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()  # built by the parent: loads, never compiles here
    init_distributed(rank=rank, world_size=world, init_method=rdzv,
                     backend=backend)
    try:
        ctx = MeshParameters(cp_shard=world).build(_cp_devices(world, backend))
        trainer = _cp_compare_trainer(ctx)
        hist = trainer.train()
        say_rank(phase="cp_train", entry="compare_step",
                 loss=hist[0]["loss"], grad_norm=hist[0]["grad_norm"])
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        cfg, make = _cp_parts(CP_LAYERS, torch.bfloat16, CP_SEQ, CP_STEPS,
                              seed=0)
        torch.cuda.reset_peak_memory_stats()
        _cp_reset_counters()
        t0 = time.perf_counter()
        trainer = make(ctx)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build = _cp_counters()
        _cp_reset_counters()
        hist = trainer.train()
        torch.cuda.synchronize()
        got = _cp_counters()
        vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
        if len(hist) != CP_STEPS or not all(map(math.isfinite, vals)):
            raise AssertionError(f"cp rank {rank}: bad history {vals}")
        walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                       for a, b in zip(hist, hist[1:])]
        # the median after the first step; the one step where there is one
        ms_step = 1e3 * statistics.median(walls[1:] or walls)
        n_params = sum(p.numel() for p in trainer.module.parameters())
        say_rank(phase="cp_train", entry="Trainer.train",
                 model="qwen3_8b", layers=cfg.num_layers,
                 layers_reduced_from=36, params=n_params,
                 cp=world, t_loc=CP_SEQ // world, global_tokens=CP_SEQ,
                 setup={"param_dtype": "float32", "dtype": "bfloat16",
                        "remat": cfg.remat_policy, "optimizer": "AdamW",
                        "backend": backend,
                        "device": str(ctx.device) + (
                            " (shared)" if backend == "gloo" else "")},
                 steps=[{"step": h["step"], "loss": h["loss"],
                         "grad_norm": h["grad_norm"]} for h in hist],
                 ms_per_step=ms_step, ms_per_step_all=[1e3 * w for w in walls],
                 ms_per_step_is=(
                     "two ranks time-share one card; gradients cross "
                     "loopback TCP: no CP throughput" if backend == "gloo"
                     else f"one card per rank over {backend}; T_loc "
                          f"{CP_SEQ // world}, not the gloo run's"),
                 grad_all_reduce_ms_per_step=(
                     1e3 * got["all_reduce_seconds"] / CP_STEPS),
                 build_seconds=build_s,
                 param_broadcast_host_staged_bytes=build[
                     "broadcast_host_staged_bytes"],
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 counters=got)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()


def _spawn_ranks(flag, ranks, backend, timeout_s, extra=(), env=None):
    """Run ``ranks`` child processes of this script (``flag RANK RANKS
    RENDEZVOUS BACKEND *extra``, with ``env`` added to their environment)
    on the card(s) and wait for them; re-emit their JSON lines and return
    them, one list per rank. A rank that exits non-zero fails the
    phase."""
    import json as _json
    import os
    import tempfile

    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               **(env or {}))
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(ranks):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag,
                 str(r), str(ranks), f"file://{tmp}/rendezvous", backend,
                 *extra],
                stdout=out, stderr=err, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for (out, err), p in zip(logs, procs):
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    failed = [(r, p.returncode, out, err)
              for r, (p, (out, err)) in enumerate(zip(procs, texts))
              if p.returncode != 0]
    if failed:
        # every failed rank: the first to fail is often not rank 0 (the
        # others then see their peer's connection reset)
        raise AssertionError("\n".join(
            f"{flag} rank {r} exited {rc}:\n{out[-1000:]}\n{err[-3000:]}"
            for r, rc, out, err in failed))
    lines = [[_json.loads(x) for x in out.splitlines() if x.startswith("{")]
             for out, _ in texts]
    for rank_lines in lines:
        for obj in rank_lines:
            say(**obj)
    return lines


def phase_cp_train(ranks=CP_RANKS, backend="gloo",
                   timeout_s=CP_CHILD_TIMEOUT_S):
    """Phase 9 in the parent: the one-process reference step, then
    ``ranks`` child processes of this script on the card(s); their lines
    are checked and re-emitted. Returns the launches of the main run (all
    ranks)."""
    import gc

    from d9d_tpu_torch.core import MeshParameters

    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 9 needs {ranks} processes on the card; its compute "
            f"mode is {mode}")
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = _cp_compare_trainer(MeshParameters().build())
    ref = trainer.train()[0]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lines = _spawn_ranks("--cp-worker", ranks, backend, timeout_s)

    def entry(r, name):
        return next(o for o in lines[r] if o.get("entry") == name)

    cmp = [entry(r, "compare_step") for r in range(ranks)]
    main = [entry(r, "Trainer.train") for r in range(ranks)]
    for r in range(1, ranks):
        if (cmp[r]["loss"], cmp[r]["grad_norm"]) != (
                cmp[0]["loss"], cmp[0]["grad_norm"]) or (
                main[r]["steps"] != main[0]["steps"]):
            raise AssertionError(f"cp ranks disagree: {cmp} {main}")
    rel = {k: abs(cmp[0][k] - ref[k]) / max(abs(ref[k]), 1e-12)
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > CP_TRAIN_TOL:
        raise AssertionError(
            f"cp compare step vs one process: {rel} (tolerance "
            f"{CP_TRAIN_TOL})")
    # per step and layer the forward runs twice (remat) and the backward
    # once; rank r attends r + 1 chunks (the rest lie in its causal future)
    per_fwd = CP_STEPS * CP_LAYERS * 2
    per_bwd = CP_STEPS * CP_LAYERS
    for r, m in enumerate(main):
        c = m["counters"]
        n_fwd, n_bwd = per_fwd * (r + 1), 2 * per_bwd * (r + 1)
        want = {"flash_block": n_fwd + n_bwd, "flash_fwd": n_fwd,
                "flash_bwd_dq": n_bwd // 2, "flash_bwd_dkv": n_bwd // 2,
                "plain_calls": 0, "eager_calls": 0, "ring_eager_blocks": 0,
                "ring_skipped_blocks":
                    (per_fwd + per_bwd) * (ranks - 1 - r)}
        if {k: c[k] for k in want} != want:
            raise AssertionError(f"cp rank {r}: counters {c}, expected {want}")
    say(phase="cp_train", entry="summary", ranks=ranks, backend=backend,
        compare={"layers": CP_COMPARE_LAYERS, "seq": CP_COMPARE_SEQ,
                 "dtype": "float32", "one_process": {
                     k: ref[k] for k in ("loss", "grad_norm")},
                 "ring": {k: cmp[0][k] for k in ("loss", "grad_norm")},
                 "rel_diff": rel, "tolerance": CP_TRAIN_TOL},
        losses=[s_["loss"] for s_ in main[0]["steps"]],
        ranks_equal=True, seconds=time.perf_counter() - t0)
    return {"flash_block": sum(m["counters"]["flash_block"] for m in main)}


# ---------------------------------------------------------------------------
# phase 10: data-parallel training on the card (fsdp_plan, B10 on pieces)
#
# Two ranks share the one card over gloo at ``dp_shard = 2``, as phase 9's
# do; gloo takes CUDA tensors in FSDP's all-gather and reduce-scatter itself
# (it copies them through host memory). The phase holds the sharded runs to
# the one-process trainer on the same seeded weights and batches and gives
# their times; it measures no data-parallel scaling. On a machine with N
# cards, ``python3 chip_smoke.py --dp-only nccl N`` runs this phase alone
# with one card per rank over NCCL.

DP_RANKS = 2
DP_CHILD_TIMEOUT_S = 600
DP_TRAIN_TOL = 1e-4  # fp32 compute: sums in other orders (rows split)
DP_ROUNDED_TOL = 2.0 ** -8  # bf16 parameters: one bf16 ulp (_dp_tolerance)
# (layers of Qwen3-8B's 36, tokens a row, steps, microbatches a step,
# compute dtype, parameter dtype). Over gloo on one card a step of any of
# them takes ≈ 15–20 s, nearly all of it FSDP's collectives moving the
# 5 GB of fp32 vocab tables (PR 16's first run: 19.8 s a main step, 96 %
# in the collectives), and a second microbatch gathers them again; the
# step counts keep the phase near 110 s. The CPU tests hold the gradient
# accumulation over microbatches (tests/test_torch_dp_train.py).
DP_RUNS = {
    # one step (cut from 2 to keep the script in its time): phase 12 holds
    # FSDP at dp_shard 2 for 2 fp32 steps, parameter pieces included
    "compare": dict(layers=1, seq=2048, steps=1, microbatches=1,
                    dtype=torch.float32, param_dtype=torch.float32),
    "bf16_params": dict(layers=1, seq=2048, steps=2, microbatches=1,
                        dtype=torch.float32, param_dtype=torch.bfloat16),
    # one step (cut from 2 to keep the script in its time)
    "main": dict(layers=2, seq=4096, steps=1, microbatches=1,
                 dtype=torch.bfloat16, param_dtype=torch.float32),
}
# FSDP's collective regions on the host thread: all-gather issue and copy
# out, reduce-scatter issue and wait
DP_COLLECTIVE_REGIONS = ("FSDP::all_gather", "FSDP::post_backward_reduce",
                         "FSDP::post_backward_rs_wait")


def _dp_tolerance(tag, step, key):
    """The rule of phase 10's comparisons: fp32 runs within DP_TRAIN_TOL
    (sums in other orders); with bf16 parameters the first loss too (the
    same weights, fp32 compute), the rest within one bf16 ulp, as each
    rank's gradient of its rows is rounded to bf16 before the sum where the
    one-process run rounds that of all rows, and the roundings that follow
    start from those sums."""
    if tag == "compare" or (step == 0 and key == "loss"):
        return DP_TRAIN_TOL
    return DP_ROUNDED_TOL


def _dp_trainer(ctx, ranks, layers, seq, steps, microbatches, dtype,
                param_dtype, seed=5):
    """A Trainer at Qwen3-8B widths and ``layers`` layers, full remat, one
    row a rank and microbatch (``ranks`` rows a microbatch whatever the
    mesh), weights drawn from ``seed``; ``fsdp_plan``, AdamW for fp32
    parameters and StochasticAdamW for bf16 ones."""
    import dataclasses

    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseConfig
    from d9d_tpu_torch.parallel import fsdp_plan

    Provider, schedule = _train_parts()

    class Planned(Provider):
        def build_plan(self, ctx):
            return fsdp_plan(ctx)

    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(), num_layers=layers)
    gbs = ranks * microbatches
    bf16 = param_dtype == torch.bfloat16
    return Trainer(
        ctx=ctx,
        config=TrainerConfig(global_batch_size=gbs, microbatch_size=ranks,
                             seq_len=seq, total_steps=steps, log_every=1,
                             max_grad_norm=1.0),
        model_provider=Planned(cfg, dtype, False, seed=seed,
                               param_dtype=param_dtype),
        dataset_provider=_Batches(cfg.vocab_size, steps, gbs, seq,
                                  seed=seed + 1, loss_mask=True),
        task=CausalLMTask(),
        optimizer_provider=(_stochastic_adamw_provider(weight_decay=0.1)
                            if bf16 else AdamWProvider(weight_decay=0.1)),
        learning_rate=schedule(3e-4, steps) if steps > 2 else 3e-4)


def _collective_ms(prof):
    """Host ms in FSDP's collective regions, by region name."""
    out = {}
    for e in prof.key_averages():
        for region in DP_COLLECTIVE_REGIONS:
            if e.key.startswith(region):
                out[region] = out.get(region, 0.0) + e.cpu_time_total / 1e3
    return out


def dp_worker(rank, world, rdzv, backend):
    """One rank of phase 10 (``chip_smoke.py --dp-worker RANK WORLD
    RENDEZVOUS BACKEND``): the fp32 comparison run, the bf16-parameter run,
    then the main run under the host profiler; every result is a JSON line
    tagged with the rank."""
    import gc
    import math
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from d9d_tpu_torch.core import (
        MeshParameters,
        init_distributed,
        shutdown_distributed,
    )
    from d9d_tpu_torch.ops import kernel_lib
    from d9d_tpu_torch.parallel.shards import local_tensor

    def say_rank(**obj):
        say(rank=rank, phase="dp_train", **obj)

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()  # built by the parent: loads, never compiles here
    init_distributed(rank=rank, world_size=world, init_method=rdzv,
                     backend=backend)
    try:
        ctx = MeshParameters(dp_shard=world).build(_cp_devices(world, backend))
        for tag in ("compare", "bf16_params"):
            reset_counters()
            t0 = time.perf_counter()
            trainer = _dp_trainer(ctx, world, **DP_RUNS[tag])
            hist = trainer.train()
            torch.cuda.synchronize()
            say_rank(entry=tag, steps=[{"loss": h["loss"],
                                        "grad_norm": h["grad_norm"]}
                                       for h in hist],
                     seconds=time.perf_counter() - t0,
                     counters=read_counters())
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

        run = DP_RUNS["main"]
        torch.cuda.reset_peak_memory_stats()
        _cp_reset_counters()
        t0 = time.perf_counter()
        trainer = _dp_trainer(ctx, world, **run)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        _cp_reset_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            hist = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        got = _cp_counters()
        vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
        if len(hist) != run["steps"] or not all(map(math.isfinite, vals)):
            raise AssertionError(f"dp rank {rank}: bad history {vals}")
        walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                       for a, b in zip(hist, hist[1:])]
        regions = _collective_ms(prof)
        with torch.no_grad():
            pieces = [local_tensor(p) for p in trainer.module.parameters()]
        say_rank(entry="Trainer.train", model="qwen3_8b",
                 layers=run["layers"], layers_reduced_from=36,
                 params=sum(p.numel() for p in trainer.module.parameters()),
                 params_on_rank=sum(p.numel() for p in pieces),
                 dp_shard=world, tokens_per_row=run["seq"],
                 global_tokens=world * run["seq"],
                 setup={"plan": "fsdp", "param_dtype": "float32",
                        "dtype": "bfloat16", "remat": "full",
                        "optimizer": "AdamW", "backend": backend,
                        "device": str(ctx.device) + (
                            " (shared)" if backend == "gloo" else "")},
                 steps=[{"step": h["step"], "loss": h["loss"],
                         "grad_norm": h["grad_norm"]} for h in hist],
                 ms_per_step=1e3 * statistics.median(walls[1:] or walls),
                 ms_per_step_is_of=("the steps after the first"
                                    if walls[1:] else "the one step"),
                 ms_per_step_all=[1e3 * w for w in walls],
                 ms_per_step_is=(
                     "two ranks time-share one card; FSDP's collectives "
                     "cross loopback TCP through host memory, under the "
                     "host profiler: no DP throughput" if backend == "gloo"
                     else f"one card per rank over {backend}, under the "
                          f"host profiler"),
                 collective_host_ms=regions,
                 collective_share_of_steps=sum(regions.values())
                 / (1e3 * train_s),
                 build_seconds=build_s,
                 build_peak_memory_bytes=build_peak,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 counters=got)
        del trainer, pieces
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()


def phase_dp_train(ranks=DP_RANKS, backend="gloo",
                   timeout_s=DP_CHILD_TIMEOUT_S):
    """Phase 10 in the parent: the one-process reference runs, then
    ``ranks`` child processes of this script on the card(s); their lines
    are checked and re-emitted. Returns the launches of the sharded runs
    (all ranks)."""
    import gc

    from d9d_tpu_torch.core import MeshParameters

    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 10 needs {ranks} processes on the card; its compute "
            f"mode is {mode}")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    for tag in ("compare", "bf16_params"):
        trainer = _dp_trainer(MeshParameters().build(), ranks,
                              **DP_RUNS[tag])
        ref[tag] = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
                    for h in trainer.train()]
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    lines = _spawn_ranks("--dp-worker", ranks, backend, timeout_s)

    def entry(r, name):
        return next(o for o in lines[r] if o.get("entry") == name)

    runs = {tag: [entry(r, tag) for r in range(ranks)]
            for tag in ("compare", "bf16_params", "Trainer.train")}
    for tag, per_rank in runs.items():
        if any(o["steps"] != per_rank[0]["steps"] for o in per_rank):
            raise AssertionError(f"dp ranks disagree in {tag}: {per_rank}")
    rel = {}
    for tag in ("compare", "bf16_params"):
        got = runs[tag][0]["steps"]
        rel[tag] = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                     for k in ("loss", "grad_norm")}
                    for g, w in zip(got, ref[tag])]
        bad = [(i, k, v) for i, r in enumerate(rel[tag]) for k, v in r.items()
               if v > _dp_tolerance(tag, i, k)]
        if len(got) != len(ref[tag]) or bad:
            raise AssertionError(
                f"dp {tag} vs one process: {rel[tag]}, over the rule: {bad}")
    run = DP_RUNS["main"]
    per_fwd = run["steps"] * run["layers"] * 2  # remat: twice a layer
    per_bwd = run["steps"] * run["layers"]
    for r, m in enumerate(runs["Trainer.train"]):
        c = m["counters"]
        want = {"flash_fwd": per_fwd, "flash_bwd_dq": per_bwd,
                "flash_bwd_dkv": per_bwd, "flash_block": 0,
                "plain_calls": 0, "eager_calls": 0}
        if {k: c[k] for k in want} != want:
            raise AssertionError(f"dp rank {r}: counters {c}, expected {want}")
    for r, b in enumerate(runs["bf16_params"]):
        c = b["counters"]
        if c["stochastic_round"] <= 0 or c["plain_calls"]:
            raise AssertionError(f"dp rank {r}: bf16 run counters {c}")
    main = runs["Trainer.train"]
    say(phase="dp_train", entry="summary", ranks=ranks, backend=backend,
        torch=torch.__version__,
        compare={tag: {"one_process": ref[tag],
                       "sharded": runs[tag][0]["steps"],
                       "rel_diff": rel[tag]} for tag in ref},
        tolerance={"fp32": DP_TRAIN_TOL, "bf16_params": {
            "step_1_loss": DP_TRAIN_TOL, "other": DP_ROUNDED_TOL}},
        runs={k: {kk: str(vv) for kk, vv in v.items()}
              for k, v in DP_RUNS.items()},
        losses=[s_["loss"] for s_ in main[0]["steps"]],
        ms_per_step=[m["ms_per_step"] for m in main],
        peak_memory_gb=[m["peak_memory_bytes"] / 1e9 for m in main],
        collective_share_of_steps=[m["collective_share_of_steps"]
                                   for m in main],
        ranks_equal=True, seconds=time.perf_counter() - t0)
    launches = {}
    for tag in ("bf16_params", "Trainer.train"):
        for o in runs[tag]:
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "stochastic_round"):
                launches[k] = launches.get(k, 0) + o["counters"][k]
    return launches


# ---------------------------------------------------------------------------
# phase 11: tensor-parallel training on the card (tp_plan and
# fsdp_plan(with_tp=True), the ring over each rank's head slice, B10 on
# block pieces)
#
# Ranks share the one card over gloo, as phase 10's do: DTensor's
# all-reduces take CUDA tensors on gloo (its all-gathers do not, and no run
# gathers a DTensor), and the port's own sums cross through pinned host
# memory. The runs are held to the one-process trainer on the same seeded
# weights and batches, and the main run gives its times; the ranks
# time-share one card, so it measures no tensor-parallel scaling. On a
# machine with N cards, ``python3 chip_smoke.py --tp-only nccl N`` runs
# this phase alone with one card per rank over NCCL.

TP_CHILD_TIMEOUT_S = 600
TP_TRAIN_TOL = 1e-4  # fp32 compute: sums in other orders (heads, rows split)
# Qwen3-8B widths (32/8 heads of 128, hidden 4096, intermediate 12288,
# vocab 151936) at ``layers`` of 36; ``rows`` a step (one microbatch), each
# ``seq`` tokens. (a) tp 2; (b) dp_shard 2 x tp 2, fp32 and bf16 parameters
# (StochasticAdamW: B10 on block pieces); (c) cp_shard 2 x tp 2, the ring
# on each rank's 16 of 32 query heads and 4 of 8 kv heads; (d) the main
# run, tp 2, timed and profiled.
TP_RUNS = {
    "tp_compare": dict(mesh=dict(tp=2), plan="tp", layers=1, seq=2048,
                       steps=2, rows=1, dtype=torch.float32,
                       param_dtype=torch.float32),
    "fsdp_tp_compare": dict(mesh=dict(dp_shard=2, tp=2), plan="fsdp_tp",
                            layers=1, seq=2048, steps=1, rows=2,
                            dtype=torch.float32, param_dtype=torch.float32),
    "fsdp_tp_bf16": dict(mesh=dict(dp_shard=2, tp=2), plan="fsdp_tp",
                         layers=1, seq=2048, steps=1, rows=2,
                         dtype=torch.float32, param_dtype=torch.bfloat16),
    "ring_tp_compare": dict(mesh=dict(cp_shard=2, tp=2), plan="fsdp_tp",
                            layers=1, seq=4096, steps=1, rows=1,
                            dtype=torch.float32, param_dtype=torch.float32),
    "main": dict(mesh=dict(tp=2), plan="tp", layers=2, seq=4096, steps=2,
                 rows=1, dtype=torch.bfloat16, param_dtype=torch.float32),
}
TP_COMPARE = ("tp_compare", "fsdp_tp_compare", "fsdp_tp_bf16",
              "ring_tp_compare")
# host-side events of the collectives on the step's thread: DTensor's
# (launch and wait) and the port's own sums and maxima
# (core/collectives.py); the backend's own threads record theirs as
# "gloo:..." / "nccl:...", which overlap the step and are not counted
TP_COLLECTIVE_EVENTS = ("all_reduce", "allreduce", "wait_tensor")
TP_BACKEND_THREADS = ("gloo:", "nccl:")


def _tp_trainer(ctx, mesh, plan, layers, seq, steps, rows, dtype,
                param_dtype, seed=7):
    """A Trainer at Qwen3-8B widths and ``layers`` layers, full remat,
    ``rows`` rows a step, weights drawn from ``seed``; ``plan`` (it cuts
    nothing on a mesh of one rank), the ring backend under cp_shard > 1;
    AdamW for fp32 parameters, StochasticAdamW for bf16 ones."""
    import dataclasses

    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
    from d9d_tpu_torch.nn.sdpa import SdpaRingConfig
    from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
    from d9d_tpu_torch.parallel import fsdp_plan, tp_plan

    Provider, schedule = _train_parts()

    class Planned(Provider):
        def build_module(self, ctx):
            if ctx.cp_size == 1:
                return super().build_module(ctx)
            return Qwen3DenseCausalLM(
                self.cfg, build_sdpa_backend(SdpaRingConfig(), ctx=ctx),
                dtype=self.dtype, param_dtype=self.param_dtype,
                device=ctx.device, seed=self.seed)

        def build_plan(self, ctx):
            return (tp_plan(ctx) if plan == "tp"
                    else fsdp_plan(ctx, with_tp=True))

    cfg = dataclasses.replace(Qwen3DenseConfig.qwen3_8b(), num_layers=layers)
    bf16 = param_dtype == torch.bfloat16
    return Trainer(
        ctx=ctx,
        config=TrainerConfig(global_batch_size=rows, microbatch_size=rows,
                             seq_len=seq, total_steps=steps, log_every=1,
                             max_grad_norm=1.0),
        model_provider=Planned(cfg, dtype, False, seed=seed,
                               param_dtype=param_dtype),
        dataset_provider=_Batches(cfg.vocab_size, steps, rows, seq,
                                  seed=seed + 1, loss_mask=True),
        task=CausalLMTask(),
        optimizer_provider=(_stochastic_adamw_provider(weight_decay=0.1)
                            if bf16 else AdamWProvider(weight_decay=0.1)),
        learning_rate=schedule(3e-4, steps) if steps > 2 else 3e-4)


def _tp_runs(world):
    """The runs of a spawn of ``world`` ranks."""
    import math

    return [tag for tag, run in TP_RUNS.items()
            if math.prod(run["mesh"].values()) == world]


def _collective_host_ms(prof):
    """Host ms in the collective events of ``prof`` (an event inside
    another counted one is not counted again), by event name."""
    out = {}
    for e in prof.events():
        if (e.name.startswith(TP_BACKEND_THREADS)
                or not any(k in e.name for k in TP_COLLECTIVE_EVENTS)):
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None and not nested:
            nested = any(k in parent.name for k in TP_COLLECTIVE_EVENTS)
            parent = parent.cpu_parent
        if not nested:
            out[e.name] = out.get(e.name, 0.0) + e.cpu_time_total / 1e3
    return out


def tp_worker(rank, world, rdzv, backend):
    """One rank of phase 11 (``chip_smoke.py --tp-worker RANK WORLD
    RENDEZVOUS BACKEND``): the comparison runs of its world size, then, at
    2 ranks, the main run under the host profiler; every result is a JSON
    line tagged with the rank."""
    import contextlib
    import gc
    import math

    from torch.profiler import ProfilerActivity, profile

    from d9d_tpu_torch.core import (
        MeshParameters,
        init_distributed,
        shutdown_distributed,
    )
    from d9d_tpu_torch.ops import kernel_lib
    from d9d_tpu_torch.parallel.shards import local_tensor
    from d9d_tpu_torch.parallel.shards import vocab_slice

    def say_rank(**obj):
        say(rank=rank, phase="tp_train", **obj)

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()  # built by the parent: loads, never compiles here
    init_distributed(rank=rank, world_size=world, init_method=rdzv,
                     backend=backend)
    try:
        for tag in _tp_runs(world):
            run = TP_RUNS[tag]
            ctx = MeshParameters(**run["mesh"]).build(
                _cp_devices(world, backend))
            torch.cuda.reset_peak_memory_stats()
            _cp_reset_counters()
            t0 = time.perf_counter()
            trainer = _tp_trainer(ctx, **run)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            seen = []
            trainer.module.lm_head.register_forward_pre_hook(
                lambda m, args: seen.append(
                    vocab_slice(m.weight)[0].shape[0]))
            _cp_reset_counters()
            with (profile(activities=[ProfilerActivity.CPU])
                  if tag == "main" else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                hist = trainer.train()
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            got = _cp_counters()
            vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
            if len(hist) != run["steps"] or not all(map(math.isfinite,
                                                         vals)):
                raise AssertionError(f"tp rank {rank} {tag}: bad history "
                                     f"{vals}")
            line = dict(
                entry=tag, steps=[{"loss": h["loss"],
                                   "grad_norm": h["grad_norm"]}
                                  for h in hist],
                ms_per_step_all=[1e3 * w for w in
                                 [hist[0]["wall_s"]] + [
                                     b["wall_s"] - a["wall_s"]
                                     for a, b in zip(hist, hist[1:])]],
                build_seconds=build_s, train_seconds=train_s,
                lm_head_rows=sorted(set(seen)),
                tp_rank=ctx.tp_rank, cp_rank=ctx.cp_rank,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                counters=got)
            if tag == "main":
                with torch.no_grad():
                    held = sum(local_tensor(p).numel()
                               for p in trainer.module.parameters())
                regions = _collective_host_ms(prof)
                line.update(
                    model="qwen3_8b", layers=run["layers"],
                    layers_reduced_from=36,
                    params=sum(p.numel()
                               for p in trainer.module.parameters()),
                    params_on_rank=held, tokens_per_step=run["seq"],
                    setup={"plan": "tp", "tp": world,
                           "param_dtype": "float32", "dtype": "bfloat16",
                           "remat": "full", "optimizer": "AdamW",
                           "backend": backend,
                           "device": str(ctx.device) + (
                               " (shared)" if backend == "gloo" else "")},
                    ms_per_step=line["ms_per_step_all"][-1],
                    ms_per_step_is_of="the last step",
                    ms_per_step_is=(
                        "two ranks time-share one card; every all-reduce "
                        "crosses loopback TCP through host memory, under "
                        "the host profiler: no TP throughput"
                        if backend == "gloo" else
                        f"one card per rank over {backend}, under the host "
                        f"profiler"),
                    collective_host_ms=regions,
                    collective_share_of_steps=sum(regions.values())
                    / (1e3 * train_s))
            say_rank(**line)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutdown_distributed()


def phase_tp_train(backend="gloo", max_ranks=4,
                   timeout_s=TP_CHILD_TIMEOUT_S):
    """Phase 11 in the parent: the one-process reference runs, then a
    spawn of 2 ranks (runs (a) and (d)) and one of 4 ((b) and (c)), as far
    as ``max_ranks`` allows; their lines are checked and re-emitted.
    Returns the launches of the sharded runs (all ranks)."""
    import gc
    import math

    from d9d_tpu_torch.core import MeshParameters

    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 11 needs {max_ranks} processes on the card; its compute "
            f"mode is {mode}")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    worlds = [w for w in (2, 4) if w <= max_ranks]
    ref = {}
    for tag in TP_COMPARE:
        run = TP_RUNS[tag]
        if math.prod(run["mesh"].values()) not in worlds:
            continue
        trainer = _tp_trainer(MeshParameters().build(), **run)
        ref[tag] = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
                    for h in trainer.train()]
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    runs = {}
    for world in worlds:
        lines = _spawn_ranks("--tp-worker", world, backend, timeout_s)
        for tag in _tp_runs(world):
            runs[tag] = [next(o for o in lines[r] if o.get("entry") == tag)
                         for r in range(world)]
    for tag, per_rank in runs.items():
        if any(o["steps"] != per_rank[0]["steps"] for o in per_rank):
            raise AssertionError(f"tp ranks disagree in {tag}: {per_rank}")
    rel = {}
    for tag in ref:
        got = runs[tag][0]["steps"]
        rel[tag] = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                     for k in ("loss", "grad_norm")}
                    for g, w in zip(got, ref[tag])]
        rule = "bf16_params" if tag == "fsdp_tp_bf16" else "compare"
        bad = [(i, k, v) for i, r in enumerate(rel[tag]) for k, v in r.items()
               if v > _dp_tolerance(rule, i, k)]
        if len(got) != len(ref[tag]) or bad:
            raise AssertionError(
                f"tp {tag} vs one process: {rel[tag]}, over the rule: {bad}")
    from d9d_tpu_torch.models.qwen3 import Qwen3DenseConfig

    vocab = Qwen3DenseConfig.qwen3_8b().vocab_size
    for tag, per_rank in runs.items():
        run = TP_RUNS[tag]
        per_fwd = run["steps"] * run["layers"] * 2  # remat: twice a layer
        per_bwd = run["steps"] * run["layers"]
        for r, o in enumerate(per_rank):
            c = o["counters"]
            if o["lm_head_rows"] != [vocab // 2]:
                raise AssertionError(
                    f"tp rank {r} {tag}: the LM head held "
                    f"{o['lm_head_rows']} vocab rows in a forward")
            if tag == "ring_tp_compare":
                # cp rank i attends i + 1 chunks (the rest lie in its
                # causal future); the backward launches dq and dk/dv
                n_fwd = per_fwd * (o["cp_rank"] + 1)
                n_bwd = 2 * per_bwd * (o["cp_rank"] + 1)
                want = {"flash_block": n_fwd + n_bwd, "flash_fwd": n_fwd,
                        "flash_bwd_dq": n_bwd // 2,
                        "flash_bwd_dkv": n_bwd // 2}
            else:
                want = {"flash_fwd": per_fwd, "flash_bwd_dq": per_bwd,
                        "flash_bwd_dkv": per_bwd, "flash_block": 0}
            want.update(plain_calls=0, eager_calls=0, ring_eager_blocks=0)
            if tag == "fsdp_tp_bf16" and c["stochastic_round"] <= 0:
                raise AssertionError(f"tp rank {r}: bf16 run rounded none")
            if {k: c[k] for k in want} != want:
                raise AssertionError(
                    f"tp rank {r} {tag}: counters {c}, expected {want}")
    main = runs.get("main", [])
    say(phase="tp_train", entry="summary", ranks=worlds, backend=backend,
        torch=torch.__version__,
        compare={tag: {"one_process": ref[tag],
                       "sharded": runs[tag][0]["steps"],
                       "rel_diff": rel[tag]} for tag in ref},
        tolerance={"fp32": TP_TRAIN_TOL, "bf16_params": {
            "step_1_loss": TP_TRAIN_TOL, "other": DP_ROUNDED_TOL}},
        runs={k: {kk: str(vv) for kk, vv in v.items()}
              for k, v in TP_RUNS.items()},
        losses=[s_["loss"] for s_ in main[0]["steps"]] if main else None,
        ms_per_step=[m["ms_per_step"] for m in main],
        peak_memory_gb=[m["peak_memory_bytes"] / 1e9 for m in main],
        collective_share_of_steps=[m["collective_share_of_steps"]
                                   for m in main],
        ranks_equal=True, seconds=time.perf_counter() - t0)
    launches = {}
    for per_rank in runs.values():
        for o in per_rank:
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "flash_block", "stochastic_round"):
                launches[k] = launches.get(k, 0) + o["counters"][k]
    return launches


# ---------------------------------------------------------------------------
# phase 12: expert-parallel training on the card (fsdp_ep_plan: the
# all-to-all dispatch, B5 on each rank's received rows at e_loc experts)
#
# Two ranks share the card over gloo, as phases 10 and 11's do: the
# dispatch's all-to-alls and its count all-gather cross through pinned host
# memory (gloo takes no CUDA tensor there), so a step's time says nothing
# of EP throughput. Each rank first runs the one-process trainer on its
# card (same seed, same batches) and keeps its final parameters; the EP
# runs are held to it step by step and, at the end, piece by piece. On a
# machine with N cards, ``python3 chip_smoke.py --ep-only nccl N`` runs
# this phase alone with one card per rank over NCCL.

EP_CHILD_TIMEOUT_S = 600
EP_TRAIN_TOL = 1e-4  # fp32 compute: sums in other orders (rows, experts apart)
# final parameters, |got - want| <= EP_PARAM_TOL * (1 + |want|): Adam's
# normalized update carries the sums' order into every element (the CPU
# tests' rtol = atol = 1e-3)
EP_PARAM_TOL = 1e-3
EP_SEQ = 2048
# Qwen3-30B-A3B widths at ``layers`` of 48, ``rows`` rows of EP_SEQ tokens a
# step (one microbatch), fp32 parameters, full remat, AdamW. (a) dp_shard N,
# ep over dp_s; (b) dp_shard N/2 x tp 2, ep over (dp_s, tp): the tp ranks
# each dispatch half of their block (dup = 2) — both fp32, held to the
# one-process run (the same N rows); (c) the main run, one row a rank, bf16
# compute, timed.
EP_RUNS = {
    # one step each (cut from 2 in PR 19 to keep the script in its time):
    # phase 13 holds expert parallelism, dup included, for 2 fp32 steps
    "ep_compare": dict(tp=False, layers=1, steps=1, dtype=torch.float32),
    "tp_ep_compare": dict(tp=True, layers=1, steps=1, dtype=torch.float32),
    "main": dict(tp=False, layers=2, steps=1, dtype=torch.bfloat16),
}


def _ep_mesh(world, tp):
    if tp:
        return dict(dp_shard=world // 2, tp=2, ep_shard=world)
    return dict(dp_shard=world, ep_shard=world)


def _ep_trainer(ctx, tp, layers, rows, steps, dtype, seed=11, seq=EP_SEQ,
                legacy=False):
    """A Trainer at Qwen3-30B-A3B widths and ``layers`` layers under
    ``fsdp_ep_plan`` (``with_tp`` for ``tp``): expert parallelism over
    ``ctx.ep_shard_axes`` with the token-layout flow (``legacy``: the
    legacy flow, ``token_axes=None``) on a mesh of more than one rank,
    local experts on one; ``rows`` rows of ``seq`` tokens a step in one
    microbatch, weights drawn from ``seed``."""
    import dataclasses

    from d9d_tpu_torch.loop import (
        AdamWProvider,
        CausalLMTask,
        ModelProvider,
        Trainer,
        TrainerConfig,
    )
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
    from d9d_tpu_torch.parallel import fsdp_ep_plan

    cfg = dataclasses.replace(Qwen3MoeConfig.qwen3_30b_a3b(),
                              num_layers=layers)
    if ctx.world_size > 1:
        cfg = dataclasses.replace(
            cfg, ep_axes=ctx.ep_shard_axes,
            moe_token_axes=None if legacy else (ctx.batch_axes,
                                                ctx.sequence_axes))

    class Planned(ModelProvider):
        def build_module(self, c):
            return Qwen3MoeCausalLM(cfg, dtype=dtype,
                                    param_dtype=torch.float32,
                                    device=c.device, seed=seed)

        def build_plan(self, c):
            return fsdp_ep_plan(c, with_tp=tp)

    return Trainer(
        ctx=ctx,
        config=TrainerConfig(global_batch_size=rows, microbatch_size=rows,
                             seq_len=seq, total_steps=steps, log_every=1,
                             max_grad_norm=1.0),
        model_provider=Planned(),
        dataset_provider=_Batches(cfg.vocab_size, steps, rows, seq,
                                  seed=seed + 1, loss_mask=True),
        task=CausalLMTask(), optimizer_provider=AdamWProvider(
            weight_decay=0.1),
        learning_rate=3e-4)


def _ep_counters():
    """read_counters, and the dispatch's: count all-gathers (each one
    readback of S), all-to-alls (calls, bytes sent, host seconds), pairs
    dropped, rows received per layer call."""
    from d9d_tpu_torch.core.collectives import (
        all_to_all_rows,
        allgather_counts,
    )
    from d9d_tpu_torch.ops.ep_dispatch import ep_dispatch_compute_combine

    d = ep_dispatch_compute_combine
    return {
        **read_counters(),
        "ep_calls": d.calls, "ep_dropped_pairs": d.dropped_pairs,
        "ep_dispatched_bytes": d.dispatched_bytes,
        "ep_recv_rows_min": d.recv_rows_min if d.calls else 0,
        "ep_recv_rows_max": d.recv_rows_max,
        "ep_recv_rows_mean": d.recv_rows_sum / max(d.calls, 1),
        "ep_s_readbacks": allgather_counts.readbacks,
        "ep_s_seconds": allgather_counts.seconds,
        "a2a_calls": all_to_all_rows.calls,
        "a2a_bytes_sent": all_to_all_rows.bytes_sent,
        "a2a_host_staged_bytes": all_to_all_rows.host_staged_bytes,
        "a2a_seconds": all_to_all_rows.seconds,
    }


def _ep_reset_counters():
    from d9d_tpu_torch.ops import ep_dispatch

    reset_counters()
    ep_dispatch.reset_counters()


def _param_rule_use(module, ref):
    """The largest ``|got - want| / (EP_PARAM_TOL * (1 + |want|))`` over
    this rank's piece of every parameter, against the same piece of the
    one-process run's parameter ``ref[name]``; and the parameter it is
    at."""
    from d9d_tpu_torch.parallel.shards import local_piece, local_tensor

    worst, at = 0.0, None
    with torch.no_grad():
        for name, p in module.named_parameters():
            got = local_tensor(p).float()
            want = local_piece(ref[name], p).float()
            if got.shape != want.shape:
                raise AssertionError(f"{name}: piece {tuple(got.shape)}, the "
                                     f"whole's piece {tuple(want.shape)}")
            use = ((got - want).abs() / (EP_PARAM_TOL * (1 + want.abs()))
                   ).max().item() if got.numel() else 0.0
            if use >= worst:
                worst, at = use, name
    return worst, at


def ep_worker(rank, world, rdzv, backend):
    """One rank of phase 12 (``chip_smoke.py --ep-worker RANK WORLD
    RENDEZVOUS BACKEND``): the one-process reference on this rank's card,
    the two comparison runs against it, then the main run; every result is
    a JSON line tagged with the rank."""
    import gc
    import math

    from torch.profiler import ProfilerActivity, profile

    from d9d_tpu_torch.core import (
        MeshParameters,
        init_distributed,
        shutdown_distributed,
    )
    from d9d_tpu_torch.ops import kernel_lib
    from d9d_tpu_torch.parallel.shards import local_tensor

    def say_rank(**obj):
        say(rank=rank, phase="ep_train", **obj)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()  # built by the parent: loads, never compiles here
    init_distributed(rank=rank, world_size=world, init_method=rdzv,
                     backend=backend)
    devices = _cp_devices(world, backend)
    try:
        run = dict(EP_RUNS["ep_compare"], rows=world)
        ref = _ep_trainer(MeshParameters().build([devices[rank]]), **run)
        ref_steps = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
                     for h in ref.train()]
        ref_params = {n: p.detach() for n, p in ref.module.named_parameters()}
        del ref
        free()
        say_rank(entry="one_process", steps=ref_steps)
        for tag in ("ep_compare", "tp_ep_compare"):
            run = dict(EP_RUNS[tag], rows=world)
            ctx = MeshParameters(**_ep_mesh(world, run["tp"])).build(devices)
            trainer = _ep_trainer(ctx, **run)
            _ep_reset_counters()
            t0 = time.perf_counter()
            hist = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            got = _ep_counters()
            steps = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
                     for h in hist]
            rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                    for k in ("loss", "grad_norm")}
                   for g, w in zip(steps, ref_steps)]
            use, at = _param_rule_use(trainer.module, ref_params)
            say_rank(entry=tag, mesh=_ep_mesh(world, run["tp"]),
                     ep_axes=list(ctx.ep_shard_axes), ep_rank=ctx.ep_rank,
                     steps=steps, rel_diff=rel, param_rule_use=use,
                     param_rule_worst_at=at, train_seconds=train_s,
                     counters=got)
            del trainer
            free()
        del ref_params
        free()

        run = dict(EP_RUNS["main"], rows=world)
        ctx = MeshParameters(**_ep_mesh(world, False)).build(devices)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = _ep_trainer(ctx, **run)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _ep_reset_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            hist = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        got = _ep_counters()
        fsdp = _collective_ms(prof)
        vals = [h[k] for h in hist
                for k in ("loss", "grad_norm", "task/moe_load_max_frac")]
        if len(hist) != run["steps"] or not all(map(math.isfinite, vals)):
            raise AssertionError(f"ep rank {rank}: bad history {vals}")
        walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                       for a, b in zip(hist, hist[1:])]
        n_steps, calls = run["steps"], max(got["ep_calls"], 1)
        with torch.no_grad():
            params = dict(trainer.module.named_parameters())
            held = sum(local_tensor(p).numel() for p in params.values())
            experts = sum(local_tensor(p).numel() for n, p in params.items()
                          if "grouped_experts" in n)
        say_rank(
            entry="Trainer.train", model="qwen3_30b_a3b",
            layers=run["layers"], layers_reduced_from=48,
            params=sum(p.numel() for p in params.values()),
            params_on_rank=held, expert_params_on_rank=experts,
            mesh=_ep_mesh(world, False), ep_axes=list(ctx.ep_shard_axes),
            ep_rank=ctx.ep_rank, tokens_per_rank=EP_SEQ,
            setup={"plan": "fsdp_ep", "param_dtype": "float32",
                   "dtype": "bfloat16", "remat": "full",
                   "optimizer": "AdamW", "backend": backend,
                   "device": str(ctx.device) + (
                       " (shared)" if backend == "gloo" else "")},
            steps=[{"step": h["step"], "loss": h["loss"],
                    "grad_norm": h["grad_norm"],
                    "moe_load_max_frac": h["task/moe_load_max_frac"]}
                   for h in hist],
            ms_per_step=1e3 * walls[-1], ms_per_step_is_of="the last step",
            ms_per_step_all=[1e3 * w for w in walls],
            ms_per_step_is=(
                "two ranks time-share one card; every all-to-all and count "
                "all-gather crosses loopback TCP through host memory, under "
                "the host profiler: no EP throughput" if backend == "gloo"
                else f"one card per rank over {backend}, under the host "
                     f"profiler"),
            a2a_host_ms_per_step=1e3 * got["a2a_seconds"] / n_steps,
            a2a_share_of_steps=got["a2a_seconds"] / train_s,
            fsdp_collective_host_ms=fsdp,
            fsdp_collective_share_of_steps=sum(fsdp.values()) / (
                1e3 * train_s),
            count_allgather_host_ms_per_step=(
                1e3 * got["ep_s_seconds"] / n_steps),
            dispatched_bytes_per_step=got["ep_dispatched_bytes"] / n_steps,
            a2a_bytes_per_step=got["a2a_bytes_sent"] / n_steps,
            a2a_calls_per_step=got["a2a_calls"] / n_steps,
            s_readbacks_per_step=got["ep_s_readbacks"] / n_steps,
            backward_group_size_readbacks_per_step=(
                got["moe_readbacks"] / n_steps),
            dropped_pairs=got["ep_dropped_pairs"],
            recv_rows_per_layer_call={
                "min": got["ep_recv_rows_min"],
                "mean": got["ep_recv_rows_mean"],
                "max": got["ep_recv_rows_max"],
                "pairs_sent_per_call": EP_SEQ * 8},
            b5_launches=got["moe_ffn_aligned"],
            b5_launches_per_layer_call=got["moe_ffn_aligned"] / calls,
            build_seconds=build_s,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            counters=got)
        del trainer, params
        free()
    finally:
        shutdown_distributed()


def phase_ep_train(backend="gloo", ranks=2, timeout_s=EP_CHILD_TIMEOUT_S):
    """Phase 12 in the parent: ``ranks`` child processes of this script
    (runs (a)–(c), each rank holding its runs to its own one-process
    reference); their lines are checked and re-emitted. Returns the
    launches of the EP runs (all ranks)."""
    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 12 needs {ranks} processes on the card; its compute "
            f"mode is {mode}")
    if ranks % 2:
        raise ValueError(f"phase 12 runs tp 2: {ranks} ranks")
    t0 = time.perf_counter()
    lines = _spawn_ranks("--ep-worker", ranks, backend, timeout_s)
    tags = ("one_process", "ep_compare", "tp_ep_compare", "Trainer.train")
    runs = {tag: [next(o for o in lines[r] if o.get("entry") == tag)
                  for r in range(ranks)] for tag in tags}
    for tag, per_rank in runs.items():
        if any(o["steps"] != per_rank[0]["steps"] for o in per_rank):
            raise AssertionError(f"ep ranks disagree in {tag}: {per_rank}")
    for tag in ("ep_compare", "tp_ep_compare"):
        for r, o in enumerate(runs[tag]):
            bad = [(i, k, v) for i, d in enumerate(o["rel_diff"])
                   for k, v in d.items() if v > EP_TRAIN_TOL]
            if (len(o["steps"]) != EP_RUNS[tag]["steps"] or bad
                    or o["param_rule_use"] > 1.0):
                raise AssertionError(
                    f"ep rank {r} {tag} vs one process: {o['rel_diff']} "
                    f"(over the rule: {bad}), parameters at "
                    f"{o['param_rule_use']} of the rule")
    launches = {}
    for tag in ("ep_compare", "tp_ep_compare", "Trainer.train"):
        run = EP_RUNS[tag if tag != "Trainer.train" else "main"]
        calls = run["steps"] * run["layers"]  # layer calls a step, one mb
        for r, o in enumerate(runs[tag]):
            c = o["counters"]
            # remat: each layer's forward runs twice (dispatch and B5
            # twice); its backward reads the group sizes once
            want = {"moe_ffn_aligned": 2 * calls, "flash_fwd": 2 * calls,
                    "flash_bwd_dq": calls, "flash_bwd_dkv": calls,
                    "ep_calls": 2 * calls, "ep_s_readbacks": 2 * calls,
                    "moe_readbacks": calls, "a2a_calls": 6 * calls,
                    "ep_dropped_pairs": 0, "plain_calls": 0,
                    "eager_calls": 0, "moe_ffn_gather": 0,
                    "moe_ffn_gather_combine": 0}
            if {k: c[k] for k in want} != want:
                raise AssertionError(
                    f"ep rank {r} {tag}: counters {c}, expected {want}")
            for k in ("moe_ffn_aligned", "flash_fwd", "flash_bwd_dq",
                      "flash_bwd_dkv"):
                launches[k] = launches.get(k, 0) + c[k]
    main = runs["Trainer.train"]
    say(phase="ep_train", entry="summary", ranks=ranks, backend=backend,
        torch=torch.__version__,
        compare={tag: {"one_process": runs["one_process"][0]["steps"],
                       "ep": runs[tag][0]["steps"],
                       "rel_diff": [o["rel_diff"] for o in runs[tag]],
                       "param_rule_use": [o["param_rule_use"]
                                          for o in runs[tag]]}
                 for tag in ("ep_compare", "tp_ep_compare")},
        tolerance={"steps": EP_TRAIN_TOL, "params": EP_PARAM_TOL},
        runs={k: {kk: str(vv) for kk, vv in v.items()}
              for k, v in EP_RUNS.items()},
        losses=[s_["loss"] for s_ in main[0]["steps"]],
        moe_load_max_frac=[s_["moe_load_max_frac"]
                           for s_ in main[0]["steps"]],
        ms_per_step=[m["ms_per_step"] for m in main],
        a2a_share_of_steps=[m["a2a_share_of_steps"] for m in main],
        fsdp_collective_share_of_steps=[
            m["fsdp_collective_share_of_steps"] for m in main],
        peak_memory_gb=[m["peak_memory_bytes"] / 1e9 for m in main],
        ranks_equal=True, launches=launches,
        seconds=time.perf_counter() - t0)
    return launches


# ---- phase 13: the example's own mesh and the export it ends with ---------
# ``example/qwen3_moe/pretrain.json``'s mesh, dp_replicate 2 x dp_shard 2 x
# tp 2, ep_shard 4 (ep over (dp_s, tp), dup = tp, the experts replicated
# over dp_r), eight ranks on one card over gloo, at Qwen3-30B-A3B widths
# and 1 of its 48 layers, one MESH_SEQ-token row a data rank. The plan is
# fsdp_ep_plan(with_tp=True): the example's plan leaves the dense weights
# whole over tp (≈ 13.7 GB a rank, 8 of them beyond the card). The parent
# first trains the one-process fp32 reference alone on the card and saves
# its final parameters (``save_params``); then (a) the mesh trains
# MESH_FP32_STEPS fp32 steps in the legacy flow (JAX's pieces of the
# flattened global batch, regrouped over the ranks), held to the reference
# step by step and, each rank reading its rows of the saved parameters,
# piece by piece; rank 0 exports the trained model through
# ``qwen3_moe_to_hf_mapper`` (``Trainer.export``) and every rank holds its
# pieces to the export bit for bit; (b) one bf16-compute step in the token
# flow, timed per rank. Last, the parent loads the export in one process
# (this one, once the ranks are gone) and its loss on the first batch must
# be the mesh's. On a machine with 8
# cards, ``python3 chip_smoke.py --mesh-only nccl 8`` runs this phase alone
# with one card per rank.

MESH_RANKS = 8
MESH_CHILD_TIMEOUT_S = 600
MESH_PARAMS = dict(dp_replicate=2, dp_shard=2, tp=2, ep_shard=4)
MESH_SEQ = 1024
MESH_ROWS = 4          # one row a data rank (dp_r x dp_s)
MESH_FP32_STEPS = 2
MESH_SHARD_GB = 2.0    # export files of at most 2 GB: the fp32 tables are 1.24
MESH_SEED = 13


def _mesh_trainer(ctx, legacy, dtype, steps):
    return _ep_trainer(ctx, tp=True, layers=1, rows=MESH_ROWS, steps=steps,
                       dtype=dtype, seed=MESH_SEED, seq=MESH_SEQ,
                       legacy=legacy)


def _mesh_config():
    import dataclasses

    from d9d_tpu_torch.models.qwen3 import Qwen3MoeConfig

    return dataclasses.replace(Qwen3MoeConfig.qwen3_30b_a3b(), num_layers=1)


def _rule_use_against(module, ref_dir):
    """:func:`_param_rule_use` against saved parameters: each rank reads
    only its pieces of them."""
    import json as _json

    from d9d_tpu_torch.model_state.io.module import read_piece
    from d9d_tpu_torch.model_state.io.safetensors_format import (
        SafetensorsFile,
    )
    from d9d_tpu_torch.parallel.shards import local_tensor

    index = _json.load(open(f"{ref_dir}/model.safetensors.index.json"))
    worst, at = 0.0, None
    with torch.no_grad():
        for name, p in module.named_parameters():
            with SafetensorsFile(f"{ref_dir}/{index['weight_map'][name]}") as f:
                want = read_piece(f, name, p).to(p.device).float()
            got = local_tensor(p).float()
            use = ((got - want).abs() / (EP_PARAM_TOL * (1 + want.abs()))
                   ).max().item() if got.numel() else 0.0
            if use >= worst:
                worst, at = use, name
    return worst, at


def _export_mismatches(module, export_dir):
    """The parameters whose piece on this rank is not, bit for bit, its
    piece of the export read back through ``qwen3_moe_from_hf_mapper``."""
    from d9d_tpu_torch.model_state import read_model_state
    from d9d_tpu_torch.models.qwen3.huggingface import (
        qwen3_moe_from_hf_mapper,
    )
    from d9d_tpu_torch.parallel.shards import local_piece, local_tensor

    params = dict(module.named_parameters())
    seen, bad = set(), []
    for name, whole in read_model_state(
            export_dir, qwen3_moe_from_hf_mapper(_mesh_config())):
        p = params[name]
        seen.add(name)
        if not torch.equal(local_piece(whole, p),
                           local_tensor(p.detach()).cpu()):
            bad.append(name)
    return bad + sorted(set(params) - seen)


def mesh_worker(rank, world, rdzv, backend, ref_dir, export_dir):
    """One rank of phase 13 (``chip_smoke.py --mesh-worker RANK WORLD
    RENDEZVOUS BACKEND REF_DIR EXPORT_DIR``): the fp32 legacy-flow run
    held to the parent's reference in ``REF_DIR``, its export to
    ``EXPORT_DIR``, then the timed bf16 token-flow step; every result is a
    JSON line tagged with the rank."""
    import faulthandler
    import gc
    import json as _json
    import math

    from torch.profiler import ProfilerActivity, profile

    from d9d_tpu_torch.core import (
        MeshParameters,
        init_distributed,
        shutdown_distributed,
    )
    from d9d_tpu_torch.models.qwen3.huggingface import qwen3_moe_to_hf_mapper
    from d9d_tpu_torch.ops import kernel_lib
    from d9d_tpu_torch.parallel.shards import local_tensor

    def say_rank(**obj):
        say(rank=rank, phase="mesh_train", **obj)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    faulthandler.enable()  # a crashed rank prints where it was
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()  # built by the parent: loads, never compiles here
    init_distributed(rank=rank, world_size=world, init_method=rdzv,
                     backend=backend)
    devices = _cp_devices(world, backend)
    try:
        ref_steps = _json.load(open(f"{ref_dir}/steps.json"))
        ctx = MeshParameters(**MESH_PARAMS).build(devices)
        trainer = _mesh_trainer(ctx, legacy=True, dtype=torch.float32,
                                steps=MESH_FP32_STEPS)
        say_rank(entry="built", allocated=torch.cuda.memory_allocated())
        _ep_reset_counters()
        t0 = time.perf_counter()
        hist = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = _ep_counters()
        steps = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
                 for h in hist]
        rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                for k in ("loss", "grad_norm")}
               for g, w in zip(steps, ref_steps)]
        use, at = _rule_use_against(trainer.module, ref_dir)
        mesh_loss = trainer.loss_on_batch(trainer.dataset_provider.batches[0])
        t0 = time.perf_counter()
        trainer.export(export_dir, mapper=qwen3_moe_to_hf_mapper(
            _mesh_config()), shard_size_gb=MESH_SHARD_GB)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mismatches = _export_mismatches(trainer.module, export_dir)
        verify_s = time.perf_counter() - t0
        index = _json.load(open(f"{export_dir}/model.safetensors.index.json"))
        say_rank(entry="fp32_legacy", mesh=MESH_PARAMS,
                 ep_axes=list(ctx.ep_shard_axes), ep_rank=ctx.ep_rank,
                 steps=steps, rel_diff=rel, param_rule_use=use,
                 param_rule_worst_at=at, train_seconds=train_s,
                 mesh_loss=mesh_loss, export_seconds=export_s,
                 export_bytes=index["metadata"]["total_size"],
                 export_files=len(set(index["weight_map"].values())),
                 export_tensors=len(index["weight_map"]),
                 export_mismatches=mismatches, verify_seconds=verify_s,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 counters=got)
        del trainer
        free()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = _mesh_trainer(ctx, legacy=False, dtype=torch.bfloat16,
                                steps=1)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _ep_reset_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            hist = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        got = _ep_counters()
        fsdp = _collective_ms(prof)
        tp_ms = _collective_host_ms(prof)
        vals = [h[k] for h in hist
                for k in ("loss", "grad_norm", "task/moe_load_max_frac")]
        if len(hist) != 1 or not all(map(math.isfinite, vals)):
            raise AssertionError(f"mesh rank {rank}: bad history {vals}")
        with torch.no_grad():
            params = dict(trainer.module.named_parameters())
            held = sum(local_tensor(p).numel() for p in params.values())
            experts = sum(local_tensor(p).numel() for n, p in params.items()
                          if "grouped_experts" in n)
        collective_ms = (sum(fsdp.values()) + 1e3 * got["a2a_seconds"]
                         + 1e3 * got["ep_s_seconds"])
        say_rank(
            entry="Trainer.train", model="qwen3_30b_a3b", layers=1,
            layers_reduced_from=48,
            params=sum(p.numel() for p in params.values()),
            params_on_rank=held, expert_params_on_rank=experts,
            mesh=MESH_PARAMS, ep_axes=list(ctx.ep_shard_axes),
            ep_rank=ctx.ep_rank, tokens_per_rank=MESH_SEQ,
            setup={"plan": "fsdp_ep(with_tp)", "flow": "token",
                   "param_dtype": "float32", "dtype": "bfloat16",
                   "remat": "full", "optimizer": "AdamW",
                   "backend": backend,
                   "device": str(ctx.device) + (
                       " (shared)" if backend == "gloo" else "")},
            steps=[{"step": h["step"], "loss": h["loss"],
                    "grad_norm": h["grad_norm"],
                    "moe_load_max_frac": h["task/moe_load_max_frac"]}
                   for h in hist],
            ms_per_step=1e3 * train_s,
            ms_per_step_is=(
                "eight ranks time-share one card; every collective crosses "
                "loopback TCP through host memory, under the host profiler: "
                "no distributed throughput" if backend == "gloo"
                else f"one card per rank over {backend}, under the host "
                     f"profiler"),
            collective_share_of_step=collective_ms / (1e3 * train_s),
            fsdp_collective_host_ms=fsdp,
            tp_collective_host_ms=sum(tp_ms.values()),
            a2a_host_ms=1e3 * got["a2a_seconds"],
            a2a_bytes=got["a2a_bytes_sent"], a2a_calls=got["a2a_calls"],
            count_allgather_host_ms=1e3 * got["ep_s_seconds"],
            s_readbacks=got["ep_s_readbacks"],
            backward_group_size_readbacks=got["moe_readbacks"],
            dropped_pairs=got["ep_dropped_pairs"],
            recv_rows_per_layer_call={
                "min": got["ep_recv_rows_min"],
                "mean": got["ep_recv_rows_mean"],
                "max": got["ep_recv_rows_max"]},
            b5_launches=got["moe_ffn_aligned"],
            build_seconds=build_s,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            counters=got)
        del trainer, params
        free()
    finally:
        shutdown_distributed()


def mesh_reference(backend, ref_dir):
    """The one-process fp32 run of phase 13, alone on the card, in a child
    of its own (``chip_smoke.py --mesh-reference 0 1 - BACKEND REF_DIR``,
    so that nothing of it stays on the card): its steps and final
    parameters into ``ref_dir``."""
    import json as _json

    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.model_state import save_params
    from d9d_tpu_torch.ops import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_lib.load()
    t0 = time.perf_counter()
    ref = _mesh_trainer(MeshParameters().build(_cp_devices(1, backend)),
                        legacy=True, dtype=torch.float32,
                        steps=MESH_FP32_STEPS)
    steps = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}
             for h in ref.train()]
    t1 = time.perf_counter()
    save_params(ref_dir, ref.module)
    with open(f"{ref_dir}/steps.json", "w") as f:
        _json.dump(steps, f)
    say(phase="mesh_train", entry="one_process", steps=steps,
        train_seconds=t1 - t0, save_seconds=time.perf_counter() - t1,
        peak_memory_bytes=torch.cuda.max_memory_allocated())


def _mesh_reload(backend, export_dir):
    """Load phase 13's export onto the card in this process, once the
    ranks are gone, through ``qwen3_moe_from_hf_mapper`` → its loss on the
    phase's first batch, the seconds the load took and the peak memory."""
    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.model_state import load_params
    from d9d_tpu_torch.models.qwen3.huggingface import (
        qwen3_moe_from_hf_mapper,
    )

    torch.cuda.reset_peak_memory_stats()
    trainer = _mesh_trainer(MeshParameters().build(_cp_devices(1, backend)),
                            legacy=True, dtype=torch.float32, steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_params(export_dir, trainer.module,
                mapper=qwen3_moe_from_hf_mapper(_mesh_config()))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    return dict(loss=trainer.loss_on_batch(trainer.dataset_provider.batches[0]),
                load_seconds=load_s,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def phase_mesh_train(backend="gloo", ranks=MESH_RANKS,
                     timeout_s=MESH_CHILD_TIMEOUT_S):
    """Phase 13 in the parent: the reference, ``ranks`` child processes of
    this script on ``pretrain.json``'s mesh, their lines checked and
    re-emitted, then the export loaded in one process. Returns the
    launches of the mesh runs (all ranks)."""
    import gc
    import shutil
    import tempfile

    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 13 needs {ranks} processes on the card; its compute "
            f"mode is {mode}")
    from d9d_tpu_torch.core import MeshParameters

    world = MeshParameters(**MESH_PARAMS).world_size
    if ranks != world:
        raise ValueError(f"phase 13's mesh {MESH_PARAMS} has {world} ranks")
    t0 = time.perf_counter()
    ref_dir, export_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        ref = _spawn_ranks("--mesh-reference", 1, backend, timeout_s,
                           extra=(ref_dir,))[0][-1]
        # eight processes share the card: grow their pools in place
        # rather than leave cached blocks stranded between them
        lines = _spawn_ranks(
            "--mesh-worker", ranks, backend, timeout_s,
            extra=(ref_dir, export_dir),
            env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        runs = {tag: [next(o for o in lines[r] if o.get("entry") == tag)
                      for r in range(ranks)]
                for tag in ("fp32_legacy", "Trainer.train")}
        for tag, per_rank in runs.items():
            if any(o["steps"] != per_rank[0]["steps"] for o in per_rank):
                raise AssertionError(f"mesh ranks disagree in {tag}: "
                                     f"{per_rank}")
        for r, o in enumerate(runs["fp32_legacy"]):
            bad = [(i, k, v) for i, d in enumerate(o["rel_diff"])
                   for k, v in d.items() if v > EP_TRAIN_TOL]
            if (len(o["steps"]) != MESH_FP32_STEPS or bad
                    or o["param_rule_use"] > 1.0 or o["export_mismatches"]):
                raise AssertionError(
                    f"mesh rank {r} vs one process: {o['rel_diff']} (over "
                    f"the rule: {bad}), parameters at {o['param_rule_use']} "
                    f"of the rule, export mismatches "
                    f"{o['export_mismatches']}")
        mesh_loss = runs["fp32_legacy"][0]["mesh_loss"]
        t1 = time.perf_counter()
        reload = _mesh_reload(backend, export_dir)
        gc.collect()
        torch.cuda.empty_cache()
        export_loss, load_s = reload["loss"], reload["load_seconds"]
        loss_rel = abs(export_loss - mesh_loss) / abs(mesh_loss)
        if loss_rel > EP_TRAIN_TOL:
            raise AssertionError(f"the export's loss {export_loss} against "
                                 f"the mesh's {mesh_loss}: {loss_rel}")
        launches = {}
        for tag, steps in (("fp32_legacy", MESH_FP32_STEPS),
                           ("Trainer.train", 1)):
            for r, o in enumerate(runs[tag]):
                c = o["counters"]
                # one layer, one microbatch a step, full remat: the layer's
                # forward runs twice, its backward reads the group sizes
                # once; the legacy flow adds its exchanges to the
                # all-to-alls (x, probs, ids out and the results home in
                # each forward, x, probs and the results back in the
                # backward)
                want = {"moe_ffn_aligned": 2 * steps, "flash_fwd": 2 * steps,
                        "flash_bwd_dq": steps, "flash_bwd_dkv": steps,
                        "ep_calls": 2 * steps, "ep_s_readbacks": 2 * steps,
                        "moe_readbacks": steps,
                        "a2a_calls": (17 if tag == "fp32_legacy" else 6)
                        * steps,
                        "ep_dropped_pairs": 0, "plain_calls": 0,
                        "eager_calls": 0, "moe_ffn_gather": 0,
                        "moe_ffn_gather_combine": 0}
                if {k: c[k] for k in want} != want:
                    raise AssertionError(
                        f"mesh rank {r} {tag}: counters {c}, expected {want}")
                for k in ("moe_ffn_aligned", "flash_fwd", "flash_bwd_dq",
                          "flash_bwd_dkv"):
                    launches[k] = launches.get(k, 0) + c[k]
        fp32, main = runs["fp32_legacy"], runs["Trainer.train"]
        say(phase="mesh_train", entry="summary", ranks=ranks,
            backend=backend, torch=torch.__version__, mesh=MESH_PARAMS,
            tokens_per_rank=MESH_SEQ,
            reference_seconds=ref["train_seconds"] + ref["save_seconds"],
            reference_peak_memory_gb=ref["peak_memory_bytes"] / 1e9,
            compare={"one_process": ref["steps"], "mesh": fp32[0]["steps"],
                     "rel_diff": [o["rel_diff"] for o in fp32],
                     "param_rule_use": [o["param_rule_use"] for o in fp32]},
            tolerance={"steps": EP_TRAIN_TOL, "params": EP_PARAM_TOL},
            export={"bytes": fp32[0]["export_bytes"],
                    "files": fp32[0]["export_files"],
                    "tensors": fp32[0]["export_tensors"],
                    "seconds": fp32[0]["export_seconds"],
                    "verify_seconds": [o["verify_seconds"] for o in fp32],
                    "bit_equal_on_every_rank": True,
                    "one_process_load_seconds": load_s,
                    "one_process_peak_memory_gb":
                        reload["peak_memory_bytes"] / 1e9,
                    "loss": export_loss, "mesh_loss": mesh_loss,
                    "loss_rel_diff": loss_rel,
                    "check_seconds": time.perf_counter() - t1},
            legacy_a2a_calls_per_step=fp32[0]["counters"]["a2a_calls"]
            / MESH_FP32_STEPS,
            fp32_peak_memory_gb=[o["peak_memory_bytes"] / 1e9 for o in fp32],
            ms_per_step=[m["ms_per_step"] for m in main],
            collective_share_of_step=[m["collective_share_of_step"]
                                      for m in main],
            a2a_host_ms=[m["a2a_host_ms"] for m in main],
            peak_memory_gb=[m["peak_memory_bytes"] / 1e9 for m in main],
            ranks_equal=True, launches=launches,
            seconds=time.perf_counter() - t0)
        return launches
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(export_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: the example end to end (the twin of example/qwen3_moe/pretrain.py)

EXAMPLE_CONFIG = "example/qwen3_moe/pretrain.json"
EXAMPLE_RANKS = 8
EXAMPLE_DROP = 40      # the newest checkpoint, deleted before the second launch
EXAMPLE_RESUMED = 20   # the step the second launch resumes from
EXAMPLE_FULL_STEPS = 4
EXAMPLE_FULL_SEQ = 2048


def _example_observe(out_dir, event, trainer, history):
    """The twin's observe hook in each rank of phase 14 (``pretrain.py``
    ``run_rank``): every count zeroed once the trainer is built, just before
    its run; after the run and the export, the counts, the history and the
    checkpointer's numbers as JSON in ``out_dir/rank{r}.json``."""
    import json as _json
    import os

    if event == "built":
        _ep_reset_counters()
        _example_observe.built_at = time.time()
        return
    ck = trainer.checkpointer
    c = _ep_counters()
    c["eager_calls"] = read_counters(trainer.module)["eager_calls"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{trainer.ctx.process_index}.json"),
              "w") as f:
        _json.dump({
            "counters": c,
            "steps": [{"step": h["step"], "loss": h["loss"],
                       "grad_norm": h["grad_norm"], "wall_s": h["wall_s"]}
                      for h in history],
            "checkpoint": None if ck is None else {
                "saves": ck.saves, "save_seconds": ck.save_seconds,
                "wait_seconds": ck.wait_seconds,
                "restore_seconds": ck.restore_seconds,
                "validate_seconds": ck.validate_seconds,
                "fallbacks": ck.checkpoint_fallback,
                "unverified_restores": ck.unverified_restore,
                "reshard_restores": ck.reshard_restores},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "built_at": _example_observe.built_at, "done_at": time.time(),
        }, f)


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _jsonl_losses(lines):
    return {r["step"]: r["value"] for r in map(json.loads, lines)
            if r.get("name") == "train/loss"}


def _example_launch(pretrain, raw, backend, out_dir):
    """One launch of the twin on ``raw`` through its launcher, every rank
    reporting into ``out_dir``; returns (seconds, per-rank reports)."""
    import functools
    import os

    t0, started = time.perf_counter(), time.time()
    pretrain.launch(raw, device="cuda", backend=backend,
                    observe=functools.partial(_example_observe, out_dir))
    seconds = time.perf_counter() - t0
    reports = [json.load(open(os.path.join(out_dir, f)))
               for f in sorted(os.listdir(out_dir),
                               key=lambda n: int(n[4:-5]))]
    for o in reports:
        # seconds from the launch to the trainer built, and from the run's
        # end (export and close included) to the launch's return
        o["start_seconds"] = o.pop("built_at") - started
        o["end_seconds"] = started + seconds - o.pop("done_at")
    return seconds, reports


def _example_check_counts(tag, reports, steps, layers, microbatches):
    """Each rank's launches: B1, B2 (dq, dk/dv) and B5 once per layer and
    microbatch of each of the ``steps`` it ran (no remat), nothing plain or
    eager, no fused backward, no other MoE kernel."""
    launches = {}
    for r, o in enumerate(reports):
        c, n = o["counters"], steps * layers * microbatches
        want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "moe_ffn_aligned": n, "flash_bwd_fused": 0,
                "moe_ffn_gather": 0, "moe_ffn_gather_combine": 0,
                "plain_calls": 0, "eager_calls": 0, "ep_dropped_pairs": 0}
        if n <= 0 or {k: c[k] for k in want} != want:
            raise AssertionError(
                f"example {tag} rank {r}: counters {c}, expected {want}")
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                  "moe_ffn_aligned"):
            launches[k] = launches.get(k, 0) + c[k]
    return launches


def phase_example(backend="gloo", ranks=EXAMPLE_RANKS):
    """Phase 14a: ``example/qwen3_moe/pretrain.json`` itself through the
    twin's launcher (``pretrain.launch``), ``ranks`` processes on the card
    over ``backend``: all its steps with its checkpoints, the JSONL tracker
    and the export, into a temp directory; then the newest checkpoint is
    deleted and the config launched again. The resumed run's JSONL losses
    and its export must equal the first run's bit for bit. Returns the
    launches of both runs (all ranks)."""
    import glob
    import math
    import os
    import shutil
    import tempfile

    from d9d_tpu_torch.core import MeshParameters
    from d9d_tpu_torch.example.qwen3_moe import pretrain

    mode = compute_mode()
    if backend == "gloo" and mode.lower().startswith("exclusive"):
        raise AssertionError(
            f"phase 14 needs {ranks} processes on the card; its compute "
            f"mode is {mode}")
    raw = json.load(open(EXAMPLE_CONFIG))
    world = MeshParameters(**raw["mesh"]).world_size
    if ranks != world:
        raise ValueError(f"{EXAMPLE_CONFIG}'s mesh has {world} ranks")
    tr = raw["trainer"]
    total, every = tr["total_steps"], tr["checkpoint_every_steps"]
    if (EXAMPLE_DROP, EXAMPLE_RESUMED) != (total, total - every):
        raise ValueError(f"{EXAMPLE_CONFIG}: total_steps {total}, "
                         f"checkpoint_every_steps {every}")
    layers = raw["model"]["num_layers"]
    microbatches = tr["global_batch_size"] // tr["microbatch_size"]
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    saved_env = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        # the file's three paths, into the temp directory: nothing is
        # written into the repository
        tr["checkpoint_dir"] = os.path.join(tmp, "ckpt")
        raw["tracker"]["directory"] = os.path.join(tmp, "runs")
        raw["export_to"] = os.path.join(tmp, "export")
        first_s, first = _example_launch(pretrain, raw, backend,
                                         os.path.join(tmp, "first"))
        (jsonl,) = glob.glob(os.path.join(tmp, "runs", "*.jsonl"))
        first_lines = open(jsonl).read().splitlines()
        export = {os.path.basename(f): open(f, "rb").read()
                  for f in glob.glob(os.path.join(tmp, "export", "*"))}
        ckpt = tr["checkpoint_dir"]
        steps_on_disk = sorted(os.listdir(ckpt))
        ckpt_bytes = _dir_bytes(os.path.join(ckpt, f"save_{EXAMPLE_DROP}"))
        shutil.rmtree(os.path.join(ckpt, f"save_{EXAMPLE_DROP}"))
        shutil.rmtree(raw["export_to"])
        second_s, second = _example_launch(pretrain, raw, backend,
                                           os.path.join(tmp, "second"))
        lines = open(jsonl).read().splitlines()
        if glob.glob(os.path.join(tmp, "runs", "*.jsonl")) != [jsonl]:
            raise AssertionError("the resumed run wrote another tracker file")
        want = {s: v for s, v in _jsonl_losses(first_lines).items()
                if s > EXAMPLE_RESUMED}
        got = _jsonl_losses(lines[len(first_lines):])
        export2 = {os.path.basename(f): open(f, "rb").read()
                   for f in glob.glob(os.path.join(tmp, "export", "*"))}
        for tag, reports in (("first", first), ("resumed", second)):
            seen = [[(h["step"], h["loss"], h["grad_norm"]) for h in o["steps"]]
                    for o in reports]
            if any(x != seen[0] for x in seen):
                raise AssertionError(f"example {tag}: ranks disagree: {seen}")
        losses = {h["step"]: h["loss"] for h in first[0]["steps"]}
        if not (got == want and sorted(want) == list(
                range(EXAMPLE_RESUMED + tr["log_every"], total + 1,
                      tr["log_every"]))):
            raise AssertionError(
                f"example: resumed JSONL losses {got} against the first "
                f"run's {want}")
        if export2 != export or not export:
            raise AssertionError("example: the resumed run's export differs "
                                 "from the first run's")
        if second[0]["steps"][0]["step"] != EXAMPLE_RESUMED + tr["log_every"]:
            raise AssertionError(f"example: the second launch did not resume "
                                 f"at {EXAMPLE_RESUMED}: {second[0]['steps']}")
        if not all(math.isfinite(v) for v in losses.values()) or not (
                losses[total] < losses[tr["log_every"]]):
            raise AssertionError(f"example: losses {losses}")
        launches = _example_check_counts("first", first, total, layers,
                                          microbatches)
        for k, n in _example_check_counts(
                "resumed", second, total - EXAMPLE_RESUMED, layers,
                microbatches).items():
            launches[k] += n
        c1, c2 = first[0]["checkpoint"], second[0]["checkpoint"]
        walls = [h["wall_s"] for h in first[0]["steps"]]
        say(phase="example", entry="pretrain.json", config=EXAMPLE_CONFIG,
            ranks=ranks, backend=backend, torch=torch.__version__,
            mesh=raw["mesh"], steps=total, layers=layers,
            head_dim=raw["model"]["head_dim"], dtype=raw["model"]["dtype"],
            loss={"step_5": losses[tr["log_every"]], "step_40": losses[total]},
            losses=losses,
            ms_per_step=1e3 * walls[-1] / total,
            ms_per_step_is=(
                "the first launch's train() wall over its steps, rank 0; "
                "eight ranks time-share one card over gloo" if backend ==
                "gloo" else f"one card per rank over {backend}"),
            launch_seconds={"first": first_s, "resumed": second_s},
            start_seconds=[o["start_seconds"] for o in first + second],
            end_seconds=[o["end_seconds"] for o in first + second],
            checkpoint={
                "steps_on_disk_after_first": steps_on_disk,
                "bytes_save_40": ckpt_bytes,
                "first_run_saves": c1["saves"],
                "save_blocking_seconds": c1["save_seconds"],
                "save_wait_seconds": c1["wait_seconds"],
                "restore_seconds": c2["restore_seconds"],
                "manifest_validation_seconds": c2["validate_seconds"],
                "resumed_from": EXAMPLE_RESUMED,
                "fallbacks": c2["fallbacks"],
                "unverified_restores": c2["unverified_restores"]},
            resumed_jsonl_losses_equal=True, resumed_export_equal=True,
            export_files=sorted(export),
            export_bytes=sum(map(len, export.values())),
            peak_memory_gb=[o["peak_memory_bytes"] / 1e9 for o in first],
            launches_per_rank={k: v // ranks for k, v in launches.items()},
            launches=launches, seconds=time.perf_counter() - t0)
        return launches
    finally:
        if saved_env is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)


def _example_full_config(tmp, steps, checkpoint):
    """Phase 14b's config in the twin's schema: Qwen3-30B-A3B widths at 1
    of its 48 layers, bf16 compute over fp32 parameters, AdamW, one rank,
    two rows of 2048 tokens a step."""
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeConfig

    m = Qwen3MoeConfig.qwen3_30b_a3b()
    return {
        "mesh": {},
        "model": {"vocab_size": m.vocab_size, "hidden_size": m.hidden_size,
                  "num_layers": 1, "num_heads": m.num_heads,
                  "num_kv_heads": m.num_kv_heads, "head_dim": m.head_dim,
                  "moe_intermediate_size": m.moe_intermediate_size,
                  "num_experts": m.num_experts,
                  "num_experts_per_tok": m.num_experts_per_tok,
                  "remat": True, "dtype": "bfloat16"},
        "data": {"num_documents": 64, "max_len": EXAMPLE_FULL_SEQ + 1,
                 "seed": 0},
        "trainer": {"global_batch_size": 2, "microbatch_size": 2,
                    "seq_len": EXAMPLE_FULL_SEQ, "total_steps": steps,
                    "log_every": 1, "gc_every_steps": None,
                    "checkpoint_dir": f"{tmp}/ckpt" if checkpoint else None,
                    "checkpoint_every_steps": 2, "checkpoints_to_keep": 1},
        "optimizer": {"type": "adamw", "b2": 0.95, "weight_decay": 0.1},
        "lr_scheduler": {"type": "constant", "value": 3e-4},
        "tracker": {"kind": "jsonl", "directory": f"{tmp}/runs"},
    }


def phase_example_full():
    """Phase 14b: the twin at Qwen3-30B-A3B widths (1 of 48 layers) in
    this process. Run 1: 2 steps, saving at 2; run 2 resumes to 4, saving
    at 4, which rotates save_2 away; run 3: 4 steps without checkpoints.
    Runs 2 and 3 must end with parameters equal bit for bit. Returns the
    launches of the three runs."""
    import gc
    import os
    import shutil
    import tempfile

    from d9d_tpu_torch.example.qwen3_moe import pretrain

    tmp = tempfile.mkdtemp()
    runs, params = {}, {}

    def observe(tag, event, trainer, history):
        if event == "built":
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            runs[tag] = {"t0": time.perf_counter()}
            if tag == "save":
                n = sum(p.numel() for p in trainer.module.parameters())
                # parameters, mu and nu in fp32; a save is written beside
                # the previous one before rotation removes it
                need = 2 * 12 * n
                free = shutil.disk_usage(tmp).free
                runs["disk"] = {"free_bytes_before_save": free,
                                "params": n, "needed_bytes": need}
                if free < need:
                    raise AssertionError(
                        f"phase 14b needs {need} bytes of disk in {tmp}, "
                        f"{free} free")
            return
        torch.cuda.synchronize()
        ck = trainer.checkpointer
        c = read_counters(trainer.module)
        runs[tag].update(
            seconds=time.perf_counter() - runs[tag].pop("t0"),
            steps=[{"step": h["step"], "loss": h["loss"],
                    "grad_norm": h["grad_norm"], "wall_s": h["wall_s"]}
                   for h in history],
            counters=c, peak_memory_bytes=torch.cuda.max_memory_allocated(),
            checkpoint=None if ck is None else {
                "saves": ck.saves, "save_seconds": ck.save_seconds,
                "wait_seconds": ck.wait_seconds,
                "restore_seconds": ck.restore_seconds,
                "validate_seconds": ck.validate_seconds,
                "steps_on_disk": [f for f in sorted(os.listdir(ck.directory))]})
        if tag in ("resumed", "straight"):
            params[tag] = {n: p.detach().to("cpu", copy=True)
                           for n, p in trainer.module.named_parameters()}

    import functools

    t0 = time.perf_counter()
    try:
        for tag, steps, ckpt in (("save", 2, True),
                                 ("resumed", EXAMPLE_FULL_STEPS, True),
                                 ("straight", EXAMPLE_FULL_STEPS, False)):
            if tag == "resumed":
                runs["bytes_save_2"] = _dir_bytes(f"{tmp}/ckpt/save_2")
            pretrain.launch(_example_full_config(tmp, steps, ckpt),
                            device="cuda",
                            observe=functools.partial(observe, tag))
            gc.collect()
            torch.cuda.empty_cache()
        bad = [n for n in params["resumed"]
               if not torch.equal(params["resumed"][n], params["straight"][n])]
        if bad or set(params["resumed"]) != set(params["straight"]):
            raise AssertionError(f"phase 14b: the resumed run's parameters "
                                 f"differ from the straight run's: {bad[:5]}")
        r1, r2, r3 = runs["save"], runs["resumed"], runs["straight"]
        if [h["step"] for h in r2["steps"]] != [3, 4]:
            raise AssertionError(f"phase 14b: resumed steps {r2['steps']}")
        if r2["checkpoint"]["steps_on_disk"] != ["save_4"]:
            raise AssertionError(f"phase 14b: rotation left "
                                 f"{r2['checkpoint']['steps_on_disk']}")
        if [h["loss"] for h in r2["steps"]] != [h["loss"] for h in
                                                r3["steps"][2:]]:
            raise AssertionError("phase 14b: resumed losses differ")
        launches = {}
        for tag, r in (("save", r1), ("resumed", r2), ("straight", r3)):
            c, n = r["counters"], len(r["steps"])
            # one layer, full remat: the forward kernels run twice a step
            want = {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n, "moe_ffn_aligned": 2 * n,
                    "plain_calls": 0, "eager_calls": 0,
                    "flash_bwd_fused": 0}
            if {k: c[k] for k in want} != want:
                raise AssertionError(
                    f"phase 14b {tag}: counters {c}, expected {want}")
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "moe_ffn_aligned"):
                launches[k] = launches.get(k, 0) + c[k]
        nbytes = runs["bytes_save_2"]
        ck1, ck2 = r1["checkpoint"], r2["checkpoint"]
        save_s = ck1["save_seconds"] + ck1["wait_seconds"]
        say(phase="example_full", model="qwen3_30b_a3b", layers=1,
            layers_reduced_from=48, params=runs["disk"]["params"],
            setup={"dtype": "bfloat16", "param_dtype": "float32",
                   "remat": "full", "optimizer": "AdamW", "rows": 2,
                   "seq": EXAMPLE_FULL_SEQ, "mesh": "one rank",
                   "checkpoint_async": True},
            disk=runs["disk"], checkpoint_bytes=nbytes,
            save={"blocking_seconds": ck1["save_seconds"],
                  "wait_seconds": ck1["wait_seconds"],
                  "gb_per_s": nbytes / save_s / 1e9},
            restore={"seconds": ck2["restore_seconds"],
                     "validate_seconds": ck2["validate_seconds"],
                     "gb_per_s": nbytes / ck2["restore_seconds"] / 1e9},
            rotation_left=ck2["steps_on_disk"],
            ms_per_step=1e3 * r3["steps"][-1]["wall_s"] / len(r3["steps"]),
            ms_per_step_is="the straight run's train() wall over its 4 steps",
            steps={t: r["steps"] for t, r in (("save", r1), ("resumed", r2),
                                              ("straight", r3))},
            resumed_params_equal_straight=True,
            peak_memory_gb={t: r["peak_memory_bytes"] / 1e9
                            for t, r in (("save", r1), ("resumed", r2),
                                         ("straight", r3))},
            launches=launches, seconds=time.perf_counter() - t0)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    import gc

    t_start = time.perf_counter()
    phase_seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[fn.__name__] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed(phase_device)
    timed(phase_build)
    kernels = timed(phase_kernels)
    for phase in (phase_small_e2e, phase_small_e2e_moe, phase_small_e2e_train,
                  phase_small_e2e_train_moe, phase_small_e2e_train_bf16):
        timed(phase)
    launches, model = timed(phase_full_width)
    for name, n in timed(phase_full_width_paged, model).items():
        launches[name] += n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (phase_full_width_moe, phase_full_width_train,
                  phase_full_width_train_moe,
                  phase_full_width_train_bf16, phase_cp_train,
                  phase_dp_train, phase_tp_train, phase_ep_train,
                  phase_mesh_train, phase_example, phase_example_full):
        for name, n in timed(phase).items():
            launches[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if launches["plain_calls"] or launches["eager_calls"]:
        raise AssertionError(f"plain/eager branch taken: {launches}")
    say(phase="done", seconds=round(time.perf_counter() - t_start, 1),
        phase_seconds=phase_seconds)
    print(smi, flush=True)
    say(kernels=kernels)
    say(ok=True, device={"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cp-worker"]:
        cp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    elif sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    elif sys.argv[1:2] == ["--ep-worker"]:
        ep_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    elif sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5], sys.argv[6], sys.argv[7])
    elif sys.argv[1:2] == ["--mesh-reference"]:
        mesh_reference(sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--example-only"]:
        # phase 14 alone: python3 chip_smoke.py --example-only nccl 8
        print(phase_device(), flush=True)
        phase_build()
        say(phase="example", launches=phase_example(sys.argv[2],
                                                    int(sys.argv[3])))
        say(phase="example_full", launches=phase_example_full())
    elif sys.argv[1:2] == ["--mesh-only"]:
        # phase 13 alone: python3 chip_smoke.py --mesh-only nccl 8
        print(phase_device(), flush=True)
        phase_build()
        say(phase="mesh_train", launches=phase_mesh_train(
            sys.argv[2], int(sys.argv[3]), timeout_s=600))
    elif sys.argv[1:2] == ["--ep-only"]:
        # phase 12 alone: python3 chip_smoke.py --ep-only nccl 2
        print(phase_device(), flush=True)
        phase_build()
        say(phase="ep_train", launches=phase_ep_train(
            sys.argv[2], int(sys.argv[3]), timeout_s=300))
    elif sys.argv[1:2] == ["--tp-only"]:
        # phase 11 alone: python3 chip_smoke.py --tp-only nccl 4
        print(phase_device(), flush=True)
        phase_build()
        say(phase="tp_train", launches=phase_tp_train(
            sys.argv[2], int(sys.argv[3]), timeout_s=300))
    elif sys.argv[1:2] == ["--dp-only"]:
        # phase 10 alone: python3 chip_smoke.py --dp-only nccl 4
        print(phase_device(), flush=True)
        phase_build()
        say(phase="dp_train", launches=phase_dp_train(
            int(sys.argv[3]), sys.argv[2], timeout_s=300))
    elif sys.argv[1:2] == ["--cp-only"]:
        # phase 9 alone: python3 chip_smoke.py --cp-only nccl 4
        print(phase_device(), flush=True)
        phase_build()
        say(phase="cp_train", launches=phase_cp_train(
            int(sys.argv[3]), sys.argv[2], timeout_s=300))
    else:
        main()
