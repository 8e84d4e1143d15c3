"""The flash-decode module of the port (``ops/attention/decode.py``) vs the
JAX package's Pallas decode kernel run in interpret mode on the CPU
(``flash_decode_attention(interpret=True, block_kv=32)``).

On the CPU the port's wrapper takes the kernel's plain PyTorch version
(``flash_decode_plain``). float32 on both sides; tolerance rtol=1e-5,
atol=2e-5 (online-softmax block order vs one-pass softmax).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention.pallas_decode import (
    flash_decode_attention as jax_decode,
)
from d9d_tpu_torch.ops.attention import decode as tdec

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
B, HQ, HKV, S, D = 3, 4, 2, 80, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, HQ, D)).astype(np.float32)
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    return q, kc, vc


@pytest.fixture(scope="module")
def jax_run():
    cache = {}

    def run(q, kc, vc, start, *, window=None, sinks=None, valid=None):
        key = (q.shape, np.ndim(start), window, sinks is not None,
               valid is not None)
        if key not in cache:
            def fn(q, kc, vc, start, sinks, valid):
                return jax_decode(
                    q, kc, vc, start=start, window_size=window, sinks=sinks,
                    kv_valid=valid, block_kv=32, interpret=True,
                )
            cache[key] = jax.jit(fn)
        return np.asarray(cache[key](
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(start, jnp.int32),
            None if sinks is None else jnp.asarray(sinks),
            None if valid is None else jnp.asarray(valid),
        ))

    return run


def _ref_lse(q, kc, start, t, window=None, valid=None):
    """Independent numpy logsumexp of the visible logits, [B, Hq, T]."""
    g = HQ // HKV
    offs = np.broadcast_to(np.asarray(start).reshape(-1), (B,))
    out = np.zeros((B, HQ, t), np.float64)
    for b in range(B):
        for h in range(HQ):
            for i in range(t):
                qp = offs[b] + i
                vis = np.arange(S) <= qp
                if window is not None:
                    vis &= np.arange(S) > qp - window
                if valid is not None:
                    vis &= valid[b] != 0
                logit = (kc[b, h // g] @ q[b, i, h]) * D**-0.5
                lv = logit[vis].astype(np.float64)
                out[b, h, i] = np.log(np.exp(lv - lv.max()).sum()) + lv.max()
    return out


_CASES = {
    "scalar_start_t1": dict(t=1, start=37),
    "per_row_start_t1": dict(t=1, start=[0, 41, 79]),
    "scalar_start_chunk": dict(t=5, start=20),
    "per_row_start_chunk": dict(t=6, start=[3, 33, 70]),
    "window": dict(t=3, start=[5, 40, 60], window=7),
    "sinks": dict(t=2, start=[9, 30, 50], sinks=True),
    "kv_valid": dict(t=2, start=[12, 30, 64], valid=True),
    "window_sinks_valid": dict(t=4, start=[8, 36, 70], window=20, sinks=True,
                               valid=True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_decode_matches_pallas_interpret(case, jax_run):
    spec = dict(_CASES[case])
    t = spec["t"]
    start = np.asarray(spec["start"], np.int32)
    q, kc, vc = _inputs(t)
    rng = np.random.default_rng(11)
    sinks = (rng.standard_normal(HQ).astype(np.float32)
             if spec.get("sinks") else None)
    valid = None
    if spec.get("valid"):
        valid = (np.arange(S)[None, :] >= np.array([[0], [4], [9]])).astype(
            np.int32)
    want = jax_run(q, kc, vc, start, window=spec.get("window"), sinks=sinks,
                   valid=valid)
    got = tdec.flash_decode_attention(
        _t(q), _t(kc), _t(vc), start=_t(start),
        window_size=spec.get("window"),
        sinks=None if sinks is None else _t(sinks),
        kv_valid=None if valid is None else _t(valid),
    )
    assert got.shape == (B, t, HQ, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # (o, lse) of the plain version, lse against an independent reference
    o, lse = tdec.flash_decode_plain(
        _t(q), _t(kc), _t(vc), start=_t(start),
        window_size=spec.get("window"),
        kv_valid=None if valid is None else _t(valid),
    )
    assert lse.shape == (B, HQ, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(),
        _ref_lse(q, kc, start, t, spec.get("window"), valid),
        rtol=1e-5, atol=2e-5,
    )
    if sinks is None:
        np.testing.assert_allclose(o.numpy(), want, **TOL)


def test_fully_masked_row_is_exact_zeros_like_pallas(jax_run):
    """kv_valid hides every slot at or before row 0's position: that row
    yields exact zeros (not a mean of V) on both sides."""
    t = 1
    q, kc, vc = _inputs(t, seed=2)
    start = np.array([5, 20, 40], np.int32)
    valid = np.ones((B, S), np.int32)
    valid[0, :6] = 0
    want = jax_run(q, kc, vc, start, valid=valid)
    o, lse = tdec.flash_decode(
        _t(q), _t(kc), _t(vc), start=_t(start), kv_valid=_t(valid)
    )
    assert (want[0] == 0).all()
    assert (o[0] == 0).all()
    np.testing.assert_allclose(lse[0].numpy(), -1e30 + np.log(1e-30),
                               rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), want, **TOL)


def test_decode_not_ported_modes_raise():
    """The argument combinations the JAX function itself refuses
    (``pallas_decode.py:408-414,435-438``): paged with ``kv_valid``, a lone
    ``k_scale``, a scale without a page table; and a query head count that
    is not a multiple of the kv heads."""
    q, kc, vc = map(_t, _inputs(1))
    start = torch.tensor(3)
    table = torch.ones(B, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="kv_valid"):
        tdec.flash_decode_attention(q, kc, vc, start=start, page_table=table,
                                    kv_valid=torch.ones(B, S))
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tdec.flash_decode_attention(q, kc, vc, start=start, page_table=table,
                                    k_scale=torch.zeros(B, HKV, S))
    with pytest.raises(NotImplementedError, match="page_table"):
        tdec.flash_decode_attention(q, kc, vc, start=start,
                                    k_scale=torch.zeros(1),
                                    v_scale=torch.zeros(1))
    with pytest.raises(ValueError, match="not a multiple"):
        tdec.flash_decode_plain(q[:, :, :3], kc, vc, start=start)


@pytest.mark.parametrize(
    "shape,expect_split",
    [((8, 8, 4, 4096), True), ((4, 8, 2048, 4096), False),
     ((1, 2, 4, 64), False)],
)
def test_decode_split_covers_the_cache(shape, expect_split):
    b, hkv, rows, s = shape
    n, length = tdec.decode_split(b, hkv, rows, s)
    assert n * length >= s and (n - 1) * length < s
    assert length % 64 == 0
    assert (n > 1) == expect_split


def test_decode_bytes_counts_visible_slots():
    got = tdec.flash_decode_bytes(
        torch.tensor([0, 10]), t=1, b=2, hq=4, hkv=2, d=16, itemsize=2
    )
    assert got == (1 + 11) * 2 * 16 * 2 * 2 + 2 * 2 * 1 * 4 * 16 * 2
