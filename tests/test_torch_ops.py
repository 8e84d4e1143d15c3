"""PyTorch port vs the JAX package, op by op, on the CPU in float32.

Inputs are made from a seed with numpy and handed to both sides. Tolerance
for single ops: rtol=1e-5, atol=1e-5 (both sides do the same fp32
arithmetic; only the order of sums differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from d9d_tpu import ops as jops
from d9d_tpu_torch import ops as tops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 32), (2, 7, 4, 8)])
def test_rms_norm_matches_jax(zero_centered, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jops.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                         zero_centered=zero_centered)
    got = tops.rms_norm(_t(x), _t(w), eps=1e-5, zero_centered=zero_centered)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_bf16_keeps_dtype_and_fp32_statistics():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((4, 64)).astype(np.float32)).bfloat16()
    w = torch.ones(64)
    got = tops.rms_norm(x, w)
    assert got.dtype == torch.bfloat16
    ref = tops.rms_norm(x.float(), w)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg = rng.standard_normal((16, 24)).astype(np.float32) * 0.2
    wu = rng.standard_normal((16, 24)).astype(np.float32) * 0.2
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    want = jops.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))
    got = tops.swiglu(*map(_t, (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g, u = x @ wg, x @ wu
    np.testing.assert_allclose(
        tops.silu_mul(_t(g), _t(u)).numpy(),
        np.asarray(jops.silu_mul(jnp.asarray(g), jnp.asarray(u))), **TOL,
    )


_SCALINGS = [
    ("none", lambda m: m.RopeScalingNone()),
    ("linear", lambda m: m.RopeScalingLinear(factor=4.0)),
    ("ntk", lambda m: m.RopeScalingNtk(factor=2.0)),
    ("yarn", lambda m: m.RopeScalingYarn(factor=4.0, original_max_position=64)),
    ("llama3", lambda m: m.RopeScalingLlama3(factor=8.0,
                                             original_max_position=64)),
]


@pytest.mark.parametrize("name,make", _SCALINGS, ids=[s[0] for s in _SCALINGS])
def test_rope_frequencies_match_jax(name, make):
    want, want_scale = jops.compute_rope_frequencies(16, 1e4, make(jops))
    got, got_scale = tops.compute_rope_frequencies(16, 1e4, make(tops))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got_scale == pytest.approx(want_scale)


def test_rope_frequencies_qwen3_theta():
    want, _ = jops.compute_rope_frequencies(128, 1_000_000.0)
    got, _ = tops.compute_rope_frequencies(128, 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_rope_cos_sin_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    inv_j, _ = jops.compute_rope_frequencies(16, 1e4)
    inv_t, _ = tops.compute_rope_frequencies(16, 1e4)
    cj, sj = jops.make_rope_cos_sin(jnp.asarray(pos), inv_j, 1.25)
    ct, st = tops.make_rope_cos_sin(_t(pos), inv_t, 1.25)
    assert ct.shape == (2, 9, 8)
    # angles reach ~500 rad: fp32 sin/cos of the two libraries agree to 1e-4
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)


@pytest.mark.parametrize("style", ["HALF", "INTERLEAVED"])
def test_apply_rope_matches_jax(style):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    ang = rng.standard_normal((2, 6, 8)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = jops.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                           getattr(jops.RopeStyle, style))
    got = tops.apply_rope(_t(x), _t(cos), _t(sin),
                          getattr(tops.RopeStyle, style))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rope_partial_rotary():
    """Partial rotary is a slice at the caller: rotate the first 8 of 16
    dims with the first 4 frequencies, pass the rest through."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    ang = rng.standard_normal((1, 5, 8)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = jnp.concatenate([
        jops.apply_rope(jnp.asarray(x[..., :8]), jnp.asarray(cos[..., :4]),
                        jnp.asarray(sin[..., :4])),
        jnp.asarray(x[..., 8:]),
    ], axis=-1)
    got = torch.cat([
        tops.apply_rope(_t(x[..., :8]), _t(cos[..., :4]), _t(sin[..., :4])),
        _t(x[..., 8:]),
    ], dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _qkv(rng, b, t, s, hq, hkv, d):
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


_EAGER_CASES = {
    "causal_gqa": dict(),
    "non_causal": dict(causal=False),
    "window": dict(window_size=3),
    "scale": dict(softmax_scale=0.3),
    "sinks": dict(sinks=True),
    "mask4d": dict(mask=True, causal=False),
    "segments": dict(segments=True),
    "cross_length": dict(s=11),
    "all_features": dict(window_size=4, sinks=True, segments=True),
}


@pytest.mark.parametrize("case", list(_EAGER_CASES))
def test_eager_sdpa_matches_jax(case):
    spec = dict(_EAGER_CASES[case])
    rng = np.random.default_rng(6)
    b, t, hq, hkv, d = 2, 7, 4, 2, 8
    s = spec.pop("s", t)
    q, k, v = _qkv(rng, b, t, s, hq, hkv, d)
    kw_j, kw_t = dict(spec), dict(spec)
    if spec.get("sinks"):
        sk = rng.standard_normal(hq).astype(np.float32)
        kw_j["sinks"], kw_t["sinks"] = jnp.asarray(sk), _t(sk)
    if spec.get("mask"):
        m = rng.random((b, 1, t, s)) > 0.3
        m[..., 0] = True
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), _t(m)
    if kw_j.pop("segments", False):
        kw_t.pop("segments")
        seg = np.sort(rng.integers(0, 2, (b, t)), axis=1).astype(np.int32)
        kw_j.update(q_segments=jnp.asarray(seg), kv_segments=jnp.asarray(seg))
        kw_t.update(q_segments=_t(seg), kv_segments=_t(seg))
    want = jops.eager_sdpa(*map(jnp.asarray, (q, k, v)), **kw_j)
    got = tops.eager_sdpa(*map(_t, (q, k, v)), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_eager_sdpa_fully_masked_row_is_zero_like_jax():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 3, 3, 2, 2, 8)
    m = np.ones((1, 1, 3, 3), bool)
    m[0, 0, 1, :] = False
    want = jops.eager_sdpa(*map(jnp.asarray, (q, k, v)), causal=False,
                           mask=jnp.asarray(m))
    got = tops.eager_sdpa(*map(_t, (q, k, v)), causal=False, mask=_t(m))
    assert torch.isfinite(got).all()
    assert (got[0, 1] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_eager_sdpa_rejects_bad_arguments():
    q = torch.zeros(1, 2, 3, 4)
    kv = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match="not a multiple"):
        tops.eager_sdpa(q, kv, kv)
    q = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match="together"):
        tops.eager_sdpa(q, kv, kv, q_segments=torch.zeros(1, 2))
