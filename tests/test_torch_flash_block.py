"""The flash block at global offsets (B4) of the port
(``ops/attention/flash.py``: ``flash_attention_block``,
``FlashBlockFunction``, ``combine_attention_chunks``) vs the JAX package's
``flash_attention_block`` (the Pallas kernels with ``has_positions``, run
in interpret mode on the CPU) and ``combine_attention_chunks``.

On the CPU the port's block takes the kernels' plain versions, so this
file holds the plain forward and backward at global offsets — the
arithmetic the CUDA kernels repeat on the card — against the TPU kernels'
own. Small Pallas blocks (8 x 8) make the JAX side visit and skip several
tiles. fp32 on both sides; tolerance rtol = atol = 2e-5, as the JAX ring
tests use (sums in other orders).

Rows that see no key of a block (ROADMAP C3): the port returns ``o = 0``
there and JAX the mean of the visited ``v``; both give ``lse <= -1e29``.
``o`` is compared on the rows that see a key, and those rows are pinned.
Gradients take their cotangents from a downstream
``combine_attention_chunks`` with a second, finite chunk, with a nonzero
cotangent on the merged lse: the combine weighs a row without a key to
exactly 0, so its cotangent is 0 on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention import pallas_flash as jflash
from d9d_tpu_torch.ops.attention import flash as tflash

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
B, T = 2, 24

# (q_offset, k_offset) and masks of each case; T = 24 per chunk
_CASES = {
    "diagonal": dict(qo=48, ko=48),
    "past": dict(qo=48, ko=0),
    "future": dict(qo=0, ko=48),
    "window_straddling": dict(qo=24, ko=0, window=10),
    "window_behind": dict(qo=72, ko=0, window=10),
    "segments": dict(qo=24, ko=0, seg=True),
    "gqa_g4": dict(qo=24, ko=0, hq=8, hkv=2),
    "non_causal_negative_shift": dict(qo=0, ko=48, causal=False),
    "non_causal_window": dict(qo=0, ko=20, causal=False, window=8),
    "scale_d32": dict(qo=24, ko=0, d=32, scale=0.3),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(name, seed=0):
    spec = dict(_CASES[name])
    hq, hkv, d = spec.pop("hq", 4), spec.pop("hkv", 2), spec.pop("d", 16)
    rng = np.random.default_rng(seed + len(name))
    q = rng.standard_normal((B, T, hq, d)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    seg = None
    if spec.pop("seg", False):
        # global packed-sequence ids: q chunk at 24.., k chunk at 0..
        ids = np.sort(rng.integers(0, 4, (B, 2 * T)), axis=1).astype(np.int32)
        seg = (ids[:, T:], ids[:, :T])
    kw = dict(q_offset=spec.pop("qo"), k_offset=spec.pop("ko"),
              causal=spec.pop("causal", True),
              window_size=spec.pop("window", None),
              softmax_scale=spec.pop("scale", None))
    assert not spec
    # the downstream combine: a finite partner chunk and the cotangents
    partner_o = rng.standard_normal((B, T, hq, d)).astype(np.float32)
    partner_lse = rng.standard_normal((B, hq, T)).astype(np.float32)
    g_out = rng.standard_normal((B, T, hq, d)).astype(np.float32)
    g_lse = rng.standard_normal((B, hq, T)).astype(np.float32)
    return (q, k, v), seg, kw, (partner_o, partner_lse, g_out, g_lse)


def _visible_rows(t, kw, seg):
    """[B, T] bool: the query rows that see at least one key of the block."""
    mask = tflash._mask(t, t, "cpu", kw["causal"], kw["window_size"],
                        None if seg is None else _t(seg[0]),
                        None if seg is None else _t(seg[1]),
                        kw["q_offset"], kw["k_offset"])
    return mask.expand(B, 1, 1, t, t).any(-1)[:, 0, 0].numpy()


def _jax(arrays, seg, kw, down):
    q, k, v = map(jnp.asarray, arrays)
    segs = {} if seg is None else dict(q_segments=jnp.asarray(seg[0]),
                                       kv_segments=jnp.asarray(seg[1]))
    po, plse, go, gl = map(jnp.asarray, down)

    def loss(q, k, v):
        o, lse = jflash.flash_attention_block(q, k, v, block_q=8, block_kv=8,
                                              **segs, **kw)
        out, merged = jflash.combine_attention_chunks(po, plse, o, lse)
        return jnp.sum(out * go) + jnp.sum(merged * gl), (o, lse)

    grads, (o, lse) = jax.jit(
        jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port(arrays, seg, kw, down):
    q, k, v = (_t(x).requires_grad_() for x in arrays)
    segs = {} if seg is None else dict(q_segments=_t(seg[0]),
                                       kv_segments=_t(seg[1]))
    po, plse, go, gl = map(_t, down)
    o, lse = tflash.flash_attention_block(q, k, v, **segs, **kw)
    out, merged = tflash.combine_attention_chunks(po, plse, o, lse)
    loss = (out * go).sum() + (merged * gl).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    return (o.detach().numpy(), lse.detach().numpy(),
            [g.numpy() for g in grads])


@pytest.mark.parametrize("name", list(_CASES))
def test_block_matches_jax_forward_and_grads(name):
    arrays, seg, kw, down = _case(name)
    fwd0 = tflash.flash_attention.plain_calls
    bwd0 = tflash.flash_attention_bwd.plain_calls
    want_o, want_lse, want = _jax(arrays, seg, kw, down)
    got_o, got_lse, got = _port(arrays, seg, kw, down)
    # one plain forward and one plain backward: the CPU path of the wrappers
    assert tflash.flash_attention.plain_calls == fwd0 + 1
    assert tflash.flash_attention_bwd.plain_calls == bwd0 + 1

    vis = _visible_rows(T, kw, seg)  # [B, T]
    lse_vis = vis[:, None, :].repeat(want_lse.shape[1], 1)
    np.testing.assert_allclose(got_lse[lse_vis], want_lse[lse_vis], **TOL)
    np.testing.assert_allclose(got_o[vis], want_o[vis], **TOL)
    # C3: rows without a visible key — port zeros, both lse at the sentinel
    assert (got_o[~vis] == 0).all()
    assert (got_lse[~lse_vis] <= -1e29).all()
    assert (want_lse[~lse_vis] <= -1e29).all()
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), label
        np.testing.assert_allclose(g, w, **TOL, err_msg=label)


def test_cases_reach_empty_and_partly_empty_rows():
    """The case list covers a block with no visible key at all, blocks with
    some rows without a key, and full blocks."""
    def share(name):
        _, seg, kw, _ = _case(name)
        return float(_visible_rows(T, kw, seg).mean())

    assert share("future") == 0.0
    assert share("window_behind") == 0.0
    assert 0.0 < share("window_straddling") < 1.0
    assert share("past") == 1.0 == share("non_causal_negative_shift")


def test_future_block_is_zero_with_zero_grads():
    """A block wholly in the causal future: o = 0, lse at the sentinel, and
    through a combine every gradient is exactly 0."""
    arrays, seg, kw, down = _case("future")
    o, lse, grads = _port(arrays, seg, kw, down)
    assert (o == 0).all() and (lse <= -1e29).all()
    for g in grads:
        assert (g == 0).all()


@pytest.mark.parametrize("fused", [False, True])
def test_split_chunks_compose_to_whole_sequence_attention(fused):
    """Causal attention over 4 chunks of 12 through flash_attention_block +
    combine_attention_chunks equals the whole-sequence flash forward and its
    grads; with both offsets forced to 0 it does not."""
    rng = np.random.default_rng(5)
    n, tl, hq, hkv, d = 4, 12, 4, 2, 16
    q, k, v, do = (rng.standard_normal((1, n * tl, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))

    def chunked(q, k, v, zero_offsets=False):
        outs = []
        for i in range(n):
            o = torch.zeros(1, tl, hq, d)
            lse = torch.full((1, hq, tl), tflash.NEG_BIG)
            for j in range(i + 1):
                qo, ko = (0, 0) if zero_offsets else (i * tl, j * tl)
                ob, lb = tflash.flash_attention_block(
                    q[:, i * tl:(i + 1) * tl], k[:, j * tl:(j + 1) * tl],
                    v[:, j * tl:(j + 1) * tl], q_offset=qo, k_offset=ko,
                    fused_bwd=fused)
                o, lse = tflash.combine_attention_chunks(o, lse, ob, lb)
            outs.append(o)
        return torch.cat(outs, dim=1)

    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    got = chunked(qt, kt, vt)
    got_g = torch.autograd.grad(got, (qt, kt, vt), _t(do))
    qw, kw_, vw = (_t(x).requires_grad_() for x in (q, k, v))
    want = tflash.FlashAttentionFunction.apply(
        qw, kw_, vw, None, None, None, True, None, None, False)
    want_g = torch.autograd.grad(want, (qw, kw_, vw), _t(do))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    wrong = chunked(_t(q), _t(k), _t(v), zero_offsets=True)
    assert np.abs(wrong.numpy() - want.detach().numpy()).max() > 0.1


def test_combine_matches_jax():
    rng = np.random.default_rng(3)
    o0, o1 = (rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
              for _ in range(2))
    l0, l1 = (rng.standard_normal((2, 3, 6)).astype(np.float32) * 3
              for _ in range(2))
    l1[0, :, 2] = -1e30   # a chunk without a visible key
    l0[1, 1, :] = -1e30
    want_o, want_l = jflash.combine_attention_chunks(*map(jnp.asarray,
                                                          (o0, l0, o1, l1)))
    got_o, got_l = tflash.combine_attention_chunks(*map(_t, (o0, l0, o1, l1)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6)
    assert got_o.dtype == torch.float32
    np.testing.assert_array_equal(got_o.numpy()[0, 2], o0[0, 2])


def test_block_refusals():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="equal q/kv block lengths"):
        tflash.flash_attention_block(q, q[:, :4], q[:, :4], q_offset=0,
                                     k_offset=0)
    with pytest.raises(ValueError, match="out of range"):
        tflash.flash_attention_block(q, q, q, q_offset=2 ** 31, k_offset=0)
    with pytest.raises(TypeError):
        tflash.flash_attention_block(q, q, q, q_offset=1.5, k_offset=0)
    with pytest.raises(ValueError, match="together"):
        tflash.flash_attention_block(q, q, q, q_offset=0, k_offset=0,
                                     q_segments=torch.zeros(1, 8))
