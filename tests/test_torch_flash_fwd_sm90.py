"""The arithmetic and the tile order of the bf16 flash forward designed for
the H100 (``csrc/attn_fwd_sm90.cuh``, B1 and B4's forward) against the plain
forward and the JAX Pallas forward, under the forward rule of
``chip_smoke.py`` (``ATOL``, ``RTOL``, ``ROW_RTOL``, ``LSE_TOL``).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against ``flash_attention_plain``. What it computes differently from the
plain version: logits of the bf16 inputs summed in fp32, scaled by
scale * log2(e) so the online softmax runs on exp2 over key tiles of 64 in
ascending order, p rounded to bf16 before p.v, o rounded once, lse = m *
ln(2) + log(l), and a row that sees no key written as zeros with lse at the
sentinel. This file writes that arithmetic as a plain PyTorch emulation and
holds it to the rule on small shapes (causal, window, segments, GQA groups
of 2 and 8, T not a multiple of the tile, shifts of the diagonal, past and
future blocks); it also checks the heavy-first order of the row tiles and
that the mask is skipped only on tiles every row of the block sees whole.
"""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention import pallas_flash as jflash
from d9d_tpu_torch.ops.attention import flash as tflash

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

BF16 = torch.bfloat16
BM, BN = 128, 64  # query rows per block, keys per tile (attn_fwd_sm90.cuh)
LOG2E = 1.4426950408889634
NEG_BIG = tflash.NEG_BIG


def emulate_fwd_sm90(q, k, v, *, causal=True, window_size=None,
                     q_segments=None, kv_segments=None, q_offset=0,
                     k_offset=0):
    """(o in bf16, lse) as the kernel computes them. Key tiles that a block
    visits beyond a row's visible keys are wholly masked for that row and
    change nothing (alpha = 1, p = 0), so every row walks all key tiles."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale_log2 = d ** -0.5 * LOG2E
    qf = q.float().reshape(b, t, hkv, g, d)
    mask = tflash._mask(t, t, q.device, causal, window_size, q_segments,
                        kv_segments, q_offset, k_offset)
    mask = mask.expand(b, hkv, g, t, t)
    m = torch.full((b, hkv, g, t, 1), NEG_BIG)
    l = torch.zeros((b, hkv, g, t, 1))
    o = torch.zeros((b, hkv, g, t, d))
    for j0 in range(0, t, BN):
        kt, vt = k[:, j0:j0 + BN].float(), v[:, j0:j0 + BN].float()
        mt = mask[..., j0:j0 + BN]
        x = torch.einsum("bthgd,bshd->bhgts", qf, kt) * scale_log2
        x = torch.where(mt, x, torch.full_like(x, NEG_BIG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(mt, torch.exp2(x - m_new), torch.zeros_like(x))
        l = alpha * l + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhgts,bshd->bhgtd", p.to(BF16).float(),
                                     vt)
        m = m_new
    o = o / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_BIG + math.log(1e-30)))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d)
    return o.to(BF16), lse[..., 0].reshape(b, hq, t)


def _inputs(b, t, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((b, t, h, d)).astype(np.float32)).to(BF16)
        for h in (hq, hkv, hkv))


def _segments(b, t, seed):
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(
        np.sort(rng.integers(0, 3, (b, t)), axis=1).astype(np.int32))


# (T, Hq, Hkv, D, mask keywords); B = 2
_CASES = {
    "causal": (256, 4, 2, 64, dict()),
    "causal_g8_d128": (256, 8, 1, 128, dict()),
    "t_not_a_multiple_of_the_tile": (200, 4, 2, 64, dict()),
    "window": (256, 4, 2, 64, dict(window_size=50)),
    "segments": (200, 8, 1, 64, dict(segments=True)),
    "non_causal": (136, 4, 2, 64, dict(causal=False)),
    "shift_diagonal": (256, 4, 2, 64, dict(q_offset=256, k_offset=256)),
    "shift_past": (256, 4, 2, 64, dict(q_offset=256, k_offset=0)),
    "shift_positive_partial": (200, 4, 2, 64, dict(q_offset=37, k_offset=0)),
    "shift_future": (256, 4, 2, 64, dict(q_offset=0, k_offset=256)),
    "shift_negative_causal": (256, 8, 1, 64, dict(q_offset=0, k_offset=40)),
    "shift_window_straddling": (
        256, 4, 2, 64, dict(q_offset=256, k_offset=0, window_size=96)),
}


def _case(name):
    t, hq, hkv, d, kw = _CASES[name]
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = _segments(2, t, seed=t)
        kw.update(q_segments=seg, kv_segments=seg)
    return _inputs(2, t, hq, hkv, d, seed=5 * len(name)), kw


@pytest.mark.parametrize("name", list(_CASES))
def test_emulated_forward_is_within_the_forward_rule(name):
    (q, k, v), kw = _case(name)
    op, lsep = tflash.flash_attention_plain(q, k, v, **kw)
    o, lse = emulate_fwd_sm90(q, k, v, **kw)
    assert torch.isfinite(o.float()).all()
    live = lsep > NEG_BIG / 10  # [B, Hq, T] rows that see a key
    dead = ~live
    o_live = o.transpose(1, 2)[live]
    op_live = op.transpose(1, 2)[live]
    if live.any():
        assert cs.tolerance_use(o_live, op_live, BF16) <= 1.0
        assert float((lse[live] - lsep[live]).abs().max()) <= cs.LSE_TOL
    # a row that sees no key: exact zeros, lse the plain version's sentinel
    assert bool((o.transpose(1, 2)[dead] == 0).all())
    assert torch.equal(lse[dead], lsep[dead])


def test_no_key_rows_get_the_sentinel_lse_the_backward_relies_on():
    (q, k, v), kw = _case("shift_future")
    o, lse = emulate_fwd_sm90(q, k, v, **kw)
    assert bool((o == 0).all())
    assert bool((lse == torch.tensor(NEG_BIG + math.log(1e-30),
                                     dtype=torch.float32)).all())


def test_emulation_matches_the_jax_pallas_forward_under_the_rule():
    """One causal GQA case through the JAX package's forward kernel
    (`_fwd_call`, interpret mode, bf16 inputs)."""
    q, k, v = _inputs(1, 128, 4, 2, 64, seed=13)
    cfg = jflash._FlashConfig(
        causal=True, scale=64 ** -0.5, window=None, has_sinks=False,
        has_segments=False, block_q=32, block_kv=32, seq_len=128,
        interpret=True)

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    jo, jlse = jax.jit(lambda *a: jflash._fwd_call(cfg, *a, None, None, None))(
        jx(q), jx(k), jx(v))
    o, lse = emulate_fwd_sm90(q, k, v)
    jo = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    assert cs.tolerance_use(o, jo, BF16) <= 1.0
    assert float((lse - torch.from_numpy(np.array(jlse))).abs().max()) \
        <= cs.LSE_TOL


def _tile_of(x, t, g):
    """attn_fwd_sm90_kernel's row tile for blockIdx.x = x."""
    if t % BM == 0:
        n_it = t // BM
        return (x % g) * n_it + (n_it - 1 - x // g)
    return x


def _block_range(r0, t, g, causal, window, shift):
    """The kernel's key range [j_first, k_end) of the block at row r0."""
    rows = g * t
    r_last = min(r0 + BM, rows) - 1
    t_lo, t_hi = 0, t - 1
    if r0 // t == r_last // t:
        t_lo, t_hi = r0 % t, r_last % t
    k_begin, k_end = 0, t
    if causal:
        k_end = min(k_end, shift + t_hi + 1)
    if window is not None:
        k_begin = max(k_begin, shift + t_lo - window + 1)
    j_first = (k_begin // BN) * BN if k_begin < k_end else k_end
    return j_first, k_end, t_lo, t_hi


@pytest.mark.parametrize("t,g", [(256, 4), (2048, 4), (2048, 8), (200, 4),
                                 (100, 8)])
def test_row_tiles_are_each_launched_once_heaviest_first(t, g):
    n_blocks = -(-g * t // BM)
    tiles = [_tile_of(x, t, g) for x in range(n_blocks)]
    assert sorted(tiles) == list(range(n_blocks))
    if t % BM == 0:
        work = []
        for tile in tiles:
            j_first, k_end, _, _ = _block_range(tile * BM, t, g, True, None, 0)
            work.append(k_end - j_first)
        assert work == sorted(work, reverse=True)


def _interior(j0, r0, t, g, causal, window, shift, segments):
    """attn_fwd_sm90_kernel's `interior`: the key tile is seen whole by every
    row of the block at r0."""
    rows = g * t
    r_last = min(r0 + BM, rows) - 1
    _, _, t_lo, t_hi = _block_range(r0, t, g, causal, window, shift)
    one_head = r0 // t == r_last // t and r0 + BM <= rows and not segments
    return (one_head and j0 + BN <= t
            and (not causal or t_lo + shift >= j0 + BN - 1)
            and (window is None or t_hi + shift - window < j0))


@pytest.mark.parametrize("t,causal,window,shift", [
    (t, causal, window, shift)
    for t in (128, 200, 384)
    for causal in (True, False)
    for window in (None, 1, 70, 200)
    for shift in (-150, 0, 64, 300)
])
def test_mask_skip_only_on_tiles_every_row_sees_whole(t, causal, window,
                                                      shift):
    g = 2
    mask = tflash._mask(t, t, "cpu", causal, window, None, None, shift, 0)[
        0, 0, 0]
    for x in range(-(-g * t // BM)):
        r0 = _tile_of(x, t, g) * BM
        j_first, k_end, _, _ = _block_range(r0, t, g, causal, window, shift)
        for j0 in range(j_first, k_end, BN):
            if _interior(j0, r0, t, g, causal, window, shift, False):
                rows = [r % t for r in range(r0, r0 + BM)]
                assert mask[rows][:, j0:j0 + BN].all(), (x, j0)
