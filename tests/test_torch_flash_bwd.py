"""The flash-attention backward of the port (``ops/attention/flash.py``:
``FlashAttentionFunction``, ``flash_attention_bwd_plain``, ``sink_grad``)
vs the JAX package's Pallas backward (``_bwd_call`` under the
``custom_vjp`` ``_flash``), run in interpret mode on the CPU.

On the CPU the port's autograd ``Function`` takes the kernels' plain
versions, so this file holds the plain backward — the arithmetic the CUDA
kernels repeat — against the TPU kernels' own arithmetic, through
``jax.grad`` of ``make_pallas_flash_sdpa(fused_bwd=False)`` (split dq /
dk-dv kernels) and ``(fused_bwd=True)`` (one-pass kernel). Small blocks make
the JAX side visit several q and kv blocks, skipped ones included. float32
on both sides; tolerance rtol=1e-5 with atol=1e-5 (gradients are of order
1: the sums run in a different order, block by block on the JAX side).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention import pallas_flash as jflash
from d9d_tpu_torch.ops.attention import flash as tflash

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(b, t, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    return q, k, v, do


def _segments(b, t, seed):
    rng = np.random.default_rng(seed + 100)
    return np.sort(rng.integers(0, 3, (b, t)), axis=1).astype(np.int32)


def _no_key_segments(b, t):
    """Query segments that differ from the key segments at one position:
    with causal=False, query 5 of every row sees no key at all."""
    ks = np.zeros((b, t), np.int32)
    qs = ks.copy()
    qs[:, 5] = 7
    return qs, ks


_CASES = {
    "causal": dict(t=32),
    "non_causal": dict(t=24, causal=False),
    "window": dict(t=37, window=6),
    "gqa_g4": dict(t=24, hq=8, hkv=2),
    "segments": dict(t=37, seg=True),
    "sinks": dict(t=29, sinks=True),
    "ragged_t": dict(t=37),
    "d128": dict(t=20, d=128),
    "softmax_scale": dict(t=24, scale=0.37),
    "window_segments_sinks_g4": dict(t=40, hq=8, hkv=2, window=9, seg=True,
                                     sinks=True),
}
# the one-pass JAX kernel is held on a subset: it computes the same function
_FUSED = ("causal", "gqa_g4", "window_segments_sinks_g4")


def _case(name):
    spec = dict(_CASES[name])
    b, t = 2, spec.pop("t")
    hq, hkv, d = spec.pop("hq", 4), spec.pop("hkv", 2), spec.pop("d", 64)
    q, k, v, do = _inputs(b, t, hq, hkv, d, seed=len(name))
    seg = _segments(b, t, seed=t) if spec.pop("seg", False) else None
    sinks = (np.random.default_rng(9).standard_normal(hq).astype(np.float32)
             if spec.pop("sinks", False) else None)
    kw = dict(causal=spec.pop("causal", True), window_size=spec.pop("window", None),
              softmax_scale=spec.pop("scale", None))
    assert not spec
    return (q, k, v, do), seg, sinks, kw


def _jax_grads(fused, arrays, qs, ks, sinks, kw):
    q, k, v, do = map(jnp.asarray, arrays)
    sdpa = jflash.make_pallas_flash_sdpa(block_q=8, block_kv=8, fused_bwd=fused)
    segs = {} if qs is None else dict(q_segments=jnp.asarray(qs),
                                      kv_segments=jnp.asarray(ks))

    @jax.jit
    def run(q, k, v, s, do):
        def f(*x):
            return sdpa(*x[:3], sinks=x[3] if len(x) > 3 else None, **segs,
                        **kw)
        args = (q, k, v) if s is None else (q, k, v, s)
        o, vjp = jax.vjp(f, *args)
        return o, vjp(do)

    o, grads = run(q, k, v, None if sinks is None else jnp.asarray(sinks), do)
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port_grads(arrays, qs, ks, sinks, kw, fused=False):
    q, k, v, do = (_t(x).requires_grad_(i < 3) for i, x in enumerate(arrays))
    s = None if sinks is None else _t(sinks).requires_grad_()
    segs = {} if qs is None else dict(q_segments=_t(qs), kv_segments=_t(ks))
    sdpa = tflash.make_flash_sdpa(fused_bwd=fused)
    o = sdpa(q, k, v, sinks=s, **segs, **kw)
    wrt = [q, k, v] + ([s] if s is not None else [])
    grads = torch.autograd.grad(o, wrt, do)
    assert sdpa.eager_calls == 0
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(_CASES))
def test_grads_match_jax_split_backward(name):
    arrays, seg, sinks, kw = _case(name)
    before = tflash.flash_attention_bwd.plain_calls
    want_o, want = _jax_grads(False, arrays, seg, seg, sinks, kw)
    got_o, got = _port_grads(arrays, seg, seg, sinks, kw)
    assert tflash.flash_attention_bwd.plain_calls == before + 1
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for label, g, w in zip(("dq", "dk", "dv", "dsinks"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=label)


@pytest.mark.parametrize("name", _FUSED)
def test_grads_match_jax_fused_backward(name):
    arrays, seg, sinks, kw = _case(name)
    _, want = _jax_grads(True, arrays, seg, seg, sinks, kw)
    _, got = _port_grads(arrays, seg, seg, sinks, kw, fused=True)
    for label, g, w in zip(("dq", "dk", "dv", "dsinks"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=label)


def _bwd_call(arrays, lse, delta, qs, ks, kw, block=8):
    q, k, v, do = arrays
    cfg = jflash._FlashConfig(
        causal=kw["causal"], scale=q.shape[-1] ** -0.5, window=kw["window_size"],
        has_sinks=False, has_segments=qs is not None, block_q=block,
        block_kv=block, seq_len=q.shape[1], interpret=True)
    segs = (None, None) if qs is None else (jnp.asarray(qs), jnp.asarray(ks))
    call = jax.jit(lambda *a: jflash._bwd_call(cfg, *a[:6], None, *a[6:]))
    out = call(*map(jnp.asarray, (q, k, v, do, lse, delta)), *segs)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("name", ["ragged_t", "window", "segments"])
def test_plain_backward_matches_bwd_call_with_delta_supplied(name):
    arrays, seg, _, kw = _case(name)
    kw = dict(kw, softmax_scale=None)
    q, k, v, do = map(_t, arrays)
    segs = {} if seg is None else dict(q_segments=_t(seg), kv_segments=_t(seg))
    o, lse = tflash.flash_attention_plain(q, k, v, causal=kw["causal"],
                                          window_size=kw["window_size"], **segs)
    delta = torch.einsum("bthd,bthd->bht", do, o)
    got = tflash.flash_attention_bwd_plain(
        q, k, v, do, lse, delta, causal=kw["causal"],
        window_size=kw["window_size"], **segs)
    want = _bwd_call(arrays, lse.numpy(), delta.numpy(), seg, seg, kw)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=label)


def test_row_with_no_visible_key_follows_the_ungated_jax_backward():
    """A query whose segment id matches no key (non-causal, so no block is
    skipped on either side). The port's forward gives the row exact zeros
    and lse = -1e30; JAX's backward recomputes p = exp(s - lse) UNGATED, and
    s - lse rounds to 0 on every masked key, so p = 1 there. Given the same
    (lse, delta), the port's backward does the same: this is the case held
    here — the row's dq is NOT zero and it feeds every key's dk and dv, as
    in JAX, at any block size."""
    arrays = _inputs(1, 16, 4, 2, 64, seed=3)
    qs, ks = _no_key_segments(1, 16)
    q, k, v, do = map(_t, arrays)
    o, lse = tflash.flash_attention_plain(
        q, k, v, causal=False, q_segments=_t(qs), kv_segments=_t(ks))
    assert (o[0, 5] == 0).all() and (lse[0, :, 5] == -1e30).all()
    delta = torch.einsum("bthd,bthd->bht", do, o)
    got = tflash.flash_attention_bwd_plain(
        q, k, v, do, lse, delta, causal=False, q_segments=_t(qs),
        kv_segments=_t(ks))
    kw = dict(causal=False, window_size=None)
    for block in (8, 16):
        want = _bwd_call(arrays, lse.numpy(), delta.numpy(), qs, ks, kw, block)
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=label)
    assert float(got[0][0, 5].abs().max()) > 0.1  # the ungated p = 1 row


def test_no_visible_key_row_with_zero_cotangent_matches_jax_grad():
    """Through the whole Function: the forwards differ on that row (JAX's
    ungated forward gives it the mean of v over the visited keys, the
    port's gives zeros), so the row's cotangent is zero here, as it is for
    any position nothing downstream reads; then every gradient agrees."""
    arrays = list(_inputs(1, 16, 4, 2, 64, seed=4))
    arrays[3][:, 5] = 0.0
    qs, ks = _no_key_segments(1, 16)
    kw = dict(causal=False)
    _, want = _jax_grads(False, arrays, qs, ks, None, kw)
    _, got = _port_grads(arrays, qs, ks, None, kw)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=label)
    assert (got[0][0, 5] == 0).all()


def test_sink_grad_matches_the_analytic_jax_term():
    rng = np.random.default_rng(0)
    sinks = rng.standard_normal(4).astype(np.float32)
    lse = rng.standard_normal((2, 4, 9)).astype(np.float32)
    delta = rng.standard_normal((2, 4, 9)).astype(np.float32)
    p_sink = np.exp(np.minimum(sinks[None, :, None] - lse, 60.0))
    want = -(p_sink * delta).sum(axis=(0, 2))
    got = tflash.sink_grad(_t(sinks), _t(lse), _t(delta))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_serving_calls_do_not_enter_the_function():
    q, k, v, _ = map(_t, _inputs(1, 8, 4, 2, 64, seed=5))
    sdpa = tflash.make_flash_sdpa()
    before = tflash.flash_attention_bwd.plain_calls
    with torch.no_grad():
        o = sdpa(q.requires_grad_(), k, v)
    assert o.grad_fn is None
    o = sdpa(q.detach(), k, v)
    assert o.grad_fn is None
    assert tflash.flash_attention_bwd.plain_calls == before


def test_fused_bwd_applies_says_which_shapes_take_the_kernel():
    ok = dict(t=2048, num_heads=32, num_kv_heads=8, head_dim=128,
              dtype=torch.bfloat16)
    assert tflash.fused_bwd_applies(**ok)
    assert tflash.fused_bwd_applies(**dict(ok, t=131072))  # no length limit
    assert not tflash.fused_bwd_applies(**dict(ok, head_dim=96))
    assert not tflash.fused_bwd_applies(**dict(ok, dtype=torch.float16))
    assert not tflash.fused_bwd_applies(**dict(ok, num_kv_heads=5))
