"""Ring attention of the port (``ops/attention/ring.py``) in 2 and 4 gloo
processes on the CPU vs the JAX package's ``make_ring_sdpa`` under
``MeshParameters(cp_shard=N)`` on N of the virtual CPU devices (its flash
block in Pallas interpret mode), forward and gradients.

The JAX side runs in this process. The port's side runs in N worker
processes that import no JAX: each holds its sequence chunk, runs the ring
with ``impl="flash"`` (the kernels' plain versions on the CPU) and
``impl="eager"``, and writes its chunk of the output and its gradients.
Inputs and cotangents come from a numpy seed. fp32; tolerance rtol = atol =
2e-5 for outputs and gradients, as ``tests/ops/test_ring_attention.py``
holds outputs (sums in other orders; the port's backward uses the global
lse, JAX's the chain rule through each step's combine).

The window case reaches ROADMAP C3: some visited ring steps hold query rows
that see no key of the chunk (JAX computes the mean of ``v`` there, the port
zeros); every output row and gradient still matches, because the combine
weighs those rows to exactly 0.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.ops.attention.ring import make_ring_sdpa as j_make_ring_sdpa
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.ops.attention import flash as tflash
from d9d_tpu_torch.ops.attention import ring as tring

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT_S = 120
B, T_LOC, HQ, HKV, D = 2, 12, 4, 2, 16

_CASES = {
    "causal": dict(),
    "window": dict(window=9),
    "segments": dict(seg=True),
    "non_causal_sinks": dict(causal=False, sinks=True),
    "window_segments_sinks_non_causal": dict(causal=False, window=15,
                                             seg=True, sinks=True),
}
# 4 ranks: the causal ring, the window, and every option at once
_CASES_AT = {2: ("causal", "window", "segments", "non_causal_sinks"),
             4: ("causal", "window", "window_segments_sinks_non_causal")}

WORKER = r'''
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from d9d_tpu_torch.core.distributed import init_distributed, shutdown_distributed
from d9d_tpu_torch.ops.attention import flash
from d9d_tpu_torch.ops.attention.ring import ring_attention

torch.set_num_threads(1)
rank, world, rdzv, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
data = np.load(src + ".npz")
out = {}
for name, kw in json.load(open(src + ".json")).items():
    seg, use_sinks = kw.pop("seg"), kw.pop("sinks")
    q, k, v, g = (torch.from_numpy(data[f"{name}/{x}"]) for x in "qkvg")
    t = q.shape[1] // world
    sl = slice(rank * t, (rank + 1) * t)
    segs = {}
    if seg:
        ids = torch.from_numpy(data[f"{name}/seg"])[:, sl]
        segs = dict(q_segments=ids, kv_segments=ids)
    for impl in ("flash", "eager"):
        ring_attention.skipped_blocks = 0
        flash.flash_attention.plain_calls = 0
        qq, kk, vv = (x[:, sl].clone().requires_grad_() for x in (q, k, v))
        wrt = [qq, kk, vv]
        sinks = None
        if use_sinks:
            sinks = torch.from_numpy(data[f"{name}/sinks"]).requires_grad_()
            wrt.append(sinks)
        o = ring_attention(qq, kk, vv, group=dist.group.WORLD, sinks=sinks,
                           impl=impl, **segs, **kw)
        grads = torch.autograd.grad(o, wrt, g[:, sl])
        key = f"{name}/{impl}"
        out[f"{key}/o"] = o.detach().numpy()
        for label, gr in zip(("dq", "dk", "dv", "dsinks"), grads):
            out[f"{key}/{label}"] = gr.numpy()
        out[f"{key}/skipped"] = np.int64(ring_attention.skipped_blocks)
        out[f"{key}/plain_fwd"] = np.int64(flash.flash_attention.plain_calls)
out["host_staged_bytes"] = np.int64(ring_attention.host_staged_bytes)
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


@pytest.fixture(scope="module", autouse=True)
def scoped_jax_mesh():
    """A JAX context sets its mesh process-wide (``jax.set_mesh``); this
    scope puts the process's ambient mesh back when the module is done, so
    a later test file in the same process does not inherit it. The files
    that build multi-device JAX contexts import it."""
    with jax.set_mesh(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))):
        yield


def spawn(tmp_path, source, world, *args, timeout=SPAWN_TIMEOUT_S):
    """Start ``source`` in ``world`` processes (rank, world, rendezvous,
    *args); the returned function waits for them: every rank must exit 0
    within ``timeout`` seconds of the start."""
    script = tmp_path / "worker.py"
    script.write_text(source)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    rdzv = f"file://{tmp_path / 'rdzv'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), rdzv, *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, (
                f"rank {r} exited {p.returncode}:\n{text[-4000:]}")

    return wait


def _inputs(name, world):
    spec = dict(_CASES[name])
    rng = np.random.default_rng(len(name) + 10 * world)
    t = T_LOC * world
    arrays = {x: rng.standard_normal((B, t, h, D)).astype(np.float32)
              for x, h in zip("qkvg", (HQ, HKV, HKV, HQ))}
    if spec.get("sinks"):
        arrays["sinks"] = rng.standard_normal(HQ).astype(np.float32)
    if spec.get("seg"):
        arrays["seg"] = np.sort(rng.integers(0, 2 * world, (B, t)),
                                axis=1).astype(np.int32)
    kw = dict(causal=spec.get("causal", True),
              window_size=spec.get("window"))
    return arrays, kw, bool(spec.get("seg")), bool(spec.get("sinks"))


def _jax_ring(world, arrays, kw):
    ctx = JMeshParameters(cp_shard=world).build(jax.devices()[:world])
    ring = j_make_ring_sdpa(ctx.mesh, seq_axis="cp_s", batch_axes=(),
                            head_axes=())
    qkv_sh = NamedSharding(ctx.mesh, P(None, "cp_s", None, None))
    q, k, v = (jax.device_put(jnp.asarray(arrays[x]), qkv_sh) for x in "qkv")
    extra = {}
    if "seg" in arrays:
        ids = jax.device_put(jnp.asarray(arrays["seg"]),
                             NamedSharding(ctx.mesh, P(None, "cp_s")))
        extra = dict(q_segments=ids, kv_segments=ids)
    args = [q, k, v]
    if "sinks" in arrays:
        args.append(jnp.asarray(arrays["sinks"]))

    def run(*a):
        def f(*x):
            return ring(*x[:3], sinks=x[3] if len(x) > 3 else None, **extra,
                        **kw)
        o, vjp = jax.vjp(f, *a)
        return o, vjp(jnp.asarray(arrays["g"]))

    o, grads = jax.jit(run)(*args)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _c3_rows(world, kw, seg):
    """Query rows (over ranks and visited steps) that see no key of the
    chunk they attend."""
    n = 0
    for rank in range(world):
        for src in range(world):
            qo, ko = rank * T_LOC, src * T_LOC
            if not tring._visible(qo, ko, T_LOC, kw["causal"],
                                  kw["window_size"]):
                continue
            segs = (None, None)
            if seg is not None:
                segs = (torch.from_numpy(seg[:, qo:qo + T_LOC]),
                        torch.from_numpy(seg[:, ko:ko + T_LOC]))
            mask = tflash._mask(T_LOC, T_LOC, "cpu", kw["causal"],
                                kw["window_size"], *segs, qo, ko)
            n += int((~mask.expand(B, 1, 1, T_LOC, T_LOC).any(-1)).sum())
    return n


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_in_gloo_processes(tmp_path, world):
    spec, arrays_all, inputs = {}, {}, {}
    for name in _CASES_AT[world]:
        arrays, kw, seg, sinks = inputs[name] = _inputs(name, world)
        spec[name] = dict(kw, seg=seg, sinks=sinks)
        arrays_all.update({f"{name}/{x}": a for x, a in arrays.items()})
    src = tmp_path / "cases"
    np.savez(f"{src}.npz", **arrays_all)
    (tmp_path / "cases.json").write_text(json.dumps(spec))
    # the workers run while this process computes the JAX side
    wait = spawn(tmp_path, WORKER, world, src, tmp_path / "out")
    want = {name: _jax_ring(world, a[0], a[1]) for name, a in inputs.items()}
    wait()
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    assert all(int(r["host_staged_bytes"]) == 0 for r in ranks)  # CPU tensors

    for name, (want_o, want_g) in want.items():
        kw = spec[name]
        for impl in ("flash", "eager"):
            key = f"{name}/{impl}"
            got_o = np.concatenate([r[f"{key}/o"] for r in ranks], axis=1)
            np.testing.assert_allclose(got_o, want_o, **TOL, err_msg=key)
            for i, label in enumerate(("dq", "dk", "dv")):
                got = np.concatenate([r[f"{key}/{label}"] for r in ranks],
                                     axis=1)
                np.testing.assert_allclose(got, want_g[i], **TOL,
                                           err_msg=f"{key} {label}")
            if kw["sinks"]:
                got = sum(r[f"{key}/dsinks"] for r in ranks)
                np.testing.assert_allclose(got, want_g[3], **TOL,
                                           err_msg=f"{key} dsinks")
            # the flash impl's steps go through the flash wrapper (its plain
            # version on the CPU), the eager impl's do not; every chunk is
            # either run or skipped, in the forward and in the backward
            fwd_calls = [int(r[f"{key}/plain_fwd"]) for r in ranks]
            skipped = [int(r[f"{key}/skipped"]) for r in ranks]
            if impl == "flash":
                assert [f + s // 2 for f, s in zip(fwd_calls, skipped)] == (
                    [world] * world)
            else:
                assert fwd_calls == [0] * world
            if name == "causal":
                # rank r skips the cp - 1 - r chunks in its causal future
                assert skipped == [2 * (world - 1 - r) for r in range(world)]

    # the windows and the packed segments reach C3 rows in visited steps
    for name in _CASES_AT[world]:
        if "window" not in name and "segments" not in name:
            continue
        arrays, kw, _, _ = _inputs(name, world)
        assert _c3_rows(world, kw, arrays.get("seg")) > 0, name


def test_ring_of_one_rank_is_the_flash_backend():
    """cp = 1: one step, no communication, the flash function itself."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 16, h, D))
                                   .astype(np.float32)).requires_grad_()
                  for h in (HQ, HKV, HKV, HQ))
    sdpa = tring.make_ring_sdpa(MeshParameters().build(["cpu"]))
    assert sdpa.group is None
    o = sdpa(q, k, v, window_size=5)
    got = torch.autograd.grad(o, (q, k, v), g)
    want_o = tflash.FlashAttentionFunction.apply(
        q, k, v, None, None, None, True, None, 5, False)
    want = torch.autograd.grad(want_o, (q, k, v), g)
    np.testing.assert_allclose(o.detach().numpy(), want_o.detach().numpy(),
                               **TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_eager_blocks_are_counted():
    """impl="eager" counts each block it runs, forward and backward; the
    flash impl counts none."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, h, D))
                                .astype(np.float32)).requires_grad_()
               for h in (HQ, HKV, HKV))
    tring.ring_attention.eager_blocks = 0
    tring.ring_attention(q, k, v).sum().backward()
    assert tring.ring_attention.eager_blocks == 0
    tring.ring_attention(q, k, v, impl="eager").sum().backward()
    assert tring.ring_attention.eager_blocks == 2


def test_ring_refusals():
    ctx = MeshParameters().build(["cpu"])
    sdpa = tring.make_ring_sdpa(ctx)
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(NotImplementedError, match="ring attention does not "
                                                  "support arbitrary masks"):
        sdpa(q, q, q, mask=torch.ones(1, 1, 8, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="together"):
        sdpa(q, q, q, q_segments=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown ring block impl"):
        tring.ring_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="unknown ring block impl"):
        tring.make_ring_sdpa(ctx, impl="pallas")
    with pytest.raises(ValueError, match="equal q/kv shard lengths"):
        sdpa(q, q[:, :4], q[:, :4])
    # the batch is sequence-sharded over cp_s only: a ring over another axis
    # would attend within each rank's chunk
    with pytest.raises(NotImplementedError, match="'tp'"):
        tring.make_ring_sdpa(ctx, seq_axis="tp")
