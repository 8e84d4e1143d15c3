"""The flash-prefill module of the port (``ops/attention/flash.py``) vs the
JAX package's Pallas flash kernel run in interpret mode on the CPU.

On the CPU the port's wrapper takes the kernel's plain PyTorch version
(``flash_attention_plain``), so this file holds the plain version — the
arithmetic the CUDA kernel repeats — against the TPU kernel's own
arithmetic, ``(o, lse)`` both. float32 on both sides; tolerance rtol=1e-5,
atol=2e-5 (online-softmax block order vs one-pass softmax).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention import pallas_flash as jflash
from d9d_tpu_torch.ops.attention import flash as tflash
from d9d_tpu_torch.ops.attention.eager import eager_sdpa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
B, HQ, HKV, D = 2, 4, 2, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, t, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, t, HKV, D)).astype(np.float32)
    return q, k, v


def _segments(t, seed=0):
    rng = np.random.default_rng(seed + 100)
    return np.sort(rng.integers(0, 3, (B, t)), axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_block():
    """The Pallas forward as ``(o, lse)``, interpret mode, small blocks so
    several kv blocks (and skipped ones) are visited; compiled once per
    static configuration."""
    cache = {}

    def run(q, k, v, *, causal=True, window=None, seg=None):
        key = (q.shape, causal, window, seg is not None)
        if key not in cache:
            def fn(q, k, v, qs, ks):
                return jflash.flash_attention_block(
                    q, k, v, q_offset=0, k_offset=0, causal=causal,
                    window_size=window, q_segments=qs, kv_segments=ks,
                    block_q=16, block_kv=16, interpret=True,
                )
            cache[key] = jax.jit(fn)
        s = None if seg is None else jnp.asarray(seg)
        o, lse = cache[key](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s, s)
        return np.asarray(o), np.asarray(lse)

    return run


_CASES = {
    "causal": dict(t=32),
    "ragged_length": dict(t=37),           # not a multiple of the block
    "non_causal": dict(t=24, causal=False),
    "window": dict(t=37, window=5),
    "segments": dict(t=37, seg=True),
    "window_segments": dict(t=48, window=9, seg=True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_flash_o_and_lse_match_pallas_interpret(case, jax_block):
    spec = dict(_CASES[case])
    t = spec.pop("t")
    seg = _segments(t) if spec.pop("seg", False) else None
    q, k, v = _inputs(t)
    want_o, want_lse = jax_block(q, k, v, seg=seg, **spec)
    got_o, got_lse = tflash.flash_attention(
        _t(q), _t(k), _t(v),
        causal=spec.get("causal", True), window_size=spec.get("window"),
        q_segments=None if seg is None else _t(seg),
        kv_segments=None if seg is None else _t(seg),
    )
    assert got_o.shape == (B, t, HQ, D) and got_lse.shape == (B, HQ, t)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("with_segments", [False, True])
def test_flash_sdpa_with_sinks_matches_pallas_sdpa(with_segments):
    """The public backend closure, sinks folded outside the kernel."""
    t = 37
    q, k, v = _inputs(t, seed=1)
    sinks = np.random.default_rng(5).standard_normal(HQ).astype(np.float32)
    seg = _segments(t) if with_segments else None
    jkw = {} if seg is None else dict(q_segments=jnp.asarray(seg),
                                      kv_segments=jnp.asarray(seg))
    tkw = {} if seg is None else dict(q_segments=_t(seg), kv_segments=_t(seg))
    want = jflash.make_pallas_flash_sdpa(block_q=16, block_kv=16)(
        *map(jnp.asarray, (q, k, v)), sinks=jnp.asarray(sinks),
        window_size=11, **jkw,
    )
    sdpa = tflash.make_flash_sdpa()
    got = sdpa(*map(_t, (q, k, v)), sinks=_t(sinks), window_size=11, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sdpa.eager_calls == 0


def test_sink_fold_matches_pallas_fwd_lse():
    t = 24
    q, k, v = _inputs(t, seed=2)
    sinks = np.random.default_rng(6).standard_normal(HQ).astype(np.float32)
    cfg = jflash._FlashConfig(
        causal=True, scale=D**-0.5, window=None, has_sinks=True,
        has_segments=False, block_q=8, block_kv=8, seq_len=t, interpret=True,
    )
    want_o, res = jflash._flash_fwd(
        cfg, *map(jnp.asarray, (q, k, v)), jnp.asarray(sinks), None, None
    )
    o, lse = tflash.flash_attention(_t(q), _t(k), _t(v))
    got_o, got_lse = tflash.apply_sinks(o, lse, _t(sinks))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[-1]), **TOL)


def test_flash_sdpa_routes_mask_and_cross_length_to_eager_like_jax():
    t = 9
    q, k, v = _inputs(t, seed=3)
    rng = np.random.default_rng(7)
    mask = rng.random((B, 1, t, t)) > 0.4
    mask[..., 0] = True
    sdpa = tflash.make_flash_sdpa()
    got = sdpa(*map(_t, (q, k, v)), mask=_t(mask))
    want = jflash.make_pallas_flash_sdpa()(
        *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got2 = sdpa(_t(q[:, -2:]), _t(k), _t(v))
    want2 = eager_sdpa(_t(q[:, -2:]), _t(k), _t(v))
    np.testing.assert_allclose(got2.numpy(), want2.numpy(), **TOL)
    assert sdpa.eager_calls == 2


def test_flash_plain_matches_eager_and_fully_masked_rows_are_zero():
    t = 12
    q, k, v = _inputs(t, seed=4)
    o, lse = tflash.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(
        o.numpy(), eager_sdpa(_t(q), _t(k), _t(v)).numpy(), **TOL
    )
    # non-causal + disjoint segment ids: no query sees any key
    qs = torch.zeros(B, t, dtype=torch.int32)
    ks = torch.ones(B, t, dtype=torch.int32)
    o, lse = tflash.flash_attention_plain(
        _t(q), _t(k), _t(v), causal=False, q_segments=qs, kv_segments=ks
    )
    assert (o == 0).all()
    np.testing.assert_allclose(lse.numpy(), -1e30 + np.log(1e-30), rtol=1e-6)


def test_flash_argument_errors():
    q, k, v = map(_t, _inputs(8))
    with pytest.raises(ValueError, match="together"):
        tflash.flash_attention(q, k, v, q_segments=torch.zeros(B, 8))
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        tflash.flash_attention_plain(q[:, :4], k, v)
