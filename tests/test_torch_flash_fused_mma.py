"""The arithmetic and the dq order of the fused tensor-core flash backward
(``csrc/flash_bwd_fused_mma.cuh``: bf16, dq, dk and dv from one recompute)
against the plain backward and the JAX Pallas fused backward, under the
fused bf16 rule of ``chip_smoke.py``.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against ``flash_attention_bwd_plain`` and checks that two runs agree bit for
bit. What changes against the plain version: the first products take the
bf16 inputs and sum in fp32; p and ds enter the second products (dv =
p^T.do, dk = ds^T.q, dq = ds.k) as a hi/lo pair of bf16 values; dq is summed
over key tiles of 64 in ascending order, each tile's partial added into an
fp32 buffer at its turn of a turnstile. This file writes that arithmetic as
a plain PyTorch emulation and holds it to the rule on small shapes (causal,
window, segments, positive and negative shifts, GQA groups of 2 and 8); one
rounding of p and ds instead of the pair must break the rule, and so must
the lost-tile controls. It also runs the turnstile's counting, as the
kernels compute it, against the visits it must order, and the blocks'
schedule with any number of resident blocks: every block finishes, and dq
comes out the same bit for bit. The rule's constants are read from
``chip_smoke.py`` so the two cannot drift.
"""
import importlib.util
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
TILE = 64  # keys per key tile and rows per query tile, as in the kernels


def _hilo(x):
    """x as the kernel's A operands carry it: hi = bf16(x), lo = bf16(x - hi),
    their sum exact in fp32."""
    hi = x.to(BF16).float()
    return hi + (x - hi).to(BF16).float()


def _single(x):
    return x.to(BF16).float()


def _first_products(q, k, v, do, lse, delta, *, causal=True, window_size=None,
                    q_segments=None, kv_segments=None, q_offset=0,
                    k_offset=0):
    """p and ds [B, Hkv, g, T, S] in fp32 from products of the bf16 inputs
    summed in fp32; s masked to -1e30 and p = exp(s - lse) ungated, as in
    the plain version (ROADMAP C3)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qf = q.float().reshape(b, t, hkv, g, d)
    dof = do.float().reshape(b, t, hkv, g, d)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    mask = tflash._mask(t, t, q.device, causal, window_size, q_segments,
                        kv_segments, q_offset, k_offset)
    s = torch.where(mask, s, torch.full_like(s, tflash.NEG_BIG))
    p = torch.exp(s - lse.float().reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bthgd,bshd->bhgts", dof, v.float())
    ds = p * (dp - delta.float().reshape(b, hkv, g, t, 1)) * scale
    return qf, dof, p, ds


def _dq_partials(ds, k, operand=_hilo):
    """Each key tile's fp32 partial of dq = ds . k, [n_kt][B, T, Hq, D]."""
    b, hkv, g, t, _ = ds.shape
    kf = k.float()
    parts = []
    for j0 in range(0, t, TILE):
        part = torch.einsum("bhgts,bshd->bthgd", operand(ds[..., j0:j0 + TILE]),
                            kf[:, j0:j0 + TILE])
        parts.append(part.reshape(b, t, hkv * g, -1))
    return parts


def emulate_fused_bwd(q, k, v, do, lse, delta, operand=_hilo, **kw):
    """(dq, dk, dv) in bf16 as the fused tensor-core kernel computes them:
    p and ds as hi/lo pairs (``operand``) in the second products, dq summed
    over key tiles in ascending order in fp32, each output rounded once."""
    qf, dof, p, ds = _first_products(q, k, v, do, lse, delta, **kw)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for part in _dq_partials(ds, k, operand):
        dq = dq + part
    dk = torch.einsum("bhgts,bthgd->bshd", operand(ds), qf)
    dv = torch.einsum("bhgts,bthgd->bshd", operand(p), dof)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _inputs(b, t, hq, hkv, d, seed, **kw):
    """bf16 q, k, v, do from numpy, and the forward's o, lse and the
    cotangent's delta = rowsum(do * o), as the training path gives them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((b, t, h, d)).astype(np.float32)).to(BF16)
        for h in (hq, hkv, hkv, hq))
    o, lse = tflash.flash_attention_plain(q, k, v, **kw)
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float()).contiguous()
    return q, k, v, do, o, lse, delta


def _segments(b, t, seed):
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(
        np.sort(rng.integers(0, 3, (b, t)), axis=1).astype(np.int32))


# (T, Hq, Hkv, mask keywords); D = 64, B = 2
_CASES = {
    "causal": (256, 4, 2, dict()),
    "causal_g8": (200, 8, 1, dict()),
    "window": (256, 4, 2, dict(window_size=50)),
    "segments": (200, 8, 1, dict(segments=True)),
    "shift_past": (256, 4, 2, dict(q_offset=256, k_offset=0)),
    "shift_positive_partial": (200, 4, 2, dict(q_offset=37, k_offset=0)),
    "shift_negative_causal": (256, 8, 1, dict(q_offset=0, k_offset=40)),
    "shift_negative_window_non_causal": (
        200, 4, 2, dict(q_offset=0, k_offset=30, causal=False,
                        window_size=64)),
}


def _case(name):
    t, hq, hkv, kw = _CASES[name]
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = _segments(2, t, seed=t)
        kw.update(q_segments=seg, kv_segments=seg)
    return _inputs(2, t, hq, hkv, 64, seed=3 * len(name), **kw), kw


@pytest.mark.parametrize("name", list(_CASES))
def test_emulated_fused_backward_is_within_the_fused_rule(name):
    (q, k, v, do, o, lse, delta), kw = _case(name)
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    got = emulate_fused_bwd(q, k, v, do, lse, delta, **kw)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), label
        assert cs.bwd_tolerance_use(g, w, BF16, fused=True) <= 1.0, label


@pytest.mark.parametrize("name", ["causal", "window", "segments",
                                  "shift_positive_partial"])
def test_one_rounding_of_p_and_ds_breaks_the_fused_rule(name):
    """The split kernels' arithmetic (p and ds rounded to bf16 once) in the
    same emulation misses the fused rule: that is why the fused kernel
    carries the hi/lo pair."""
    (q, k, v, do, o, lse, delta), kw = _case(name)
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    got = emulate_fused_bwd(q, k, v, do, lse, delta, operand=_single, **kw)
    uses = [cs.bwd_tolerance_use(g, w, BF16, fused=True)
            for g, w in zip(got, want)]
    assert max(uses) > 1.0, uses


def test_lost_tile_controls_break_the_fused_rule_by_a_wide_margin():
    (q, k, v, do, o, lse, delta), _ = _case("causal")
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    controls = cs._lost_tile_controls(q, k, v, do, o, lse, delta, want, BF16,
                                      fused=True)
    assert min(controls.values()) > cs.FUSED_CONTROL_MIN_USE, controls


def test_emulation_matches_the_jax_pallas_fused_backward_under_the_rule():
    """One causal GQA case through the JAX package's fused backward kernel
    (`_bwd_call` with `fused_bwd=True`, interpret mode, bf16 inputs)."""
    q, k, v, do, o, lse, delta = _inputs(1, 128, 4, 2, 64, seed=11)
    cfg = jflash._FlashConfig(
        causal=True, scale=64 ** -0.5, window=None, has_sinks=False,
        has_segments=False, block_q=32, block_kv=32, seq_len=128,
        interpret=True, fused_bwd=True)
    assert jflash.fused_bwd_applies(t=128, num_heads=4, num_kv_heads=2,
                                    head_dim=64, itemsize=2, block_q=32)

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    call = jax.jit(lambda *a: jflash._bwd_call(cfg, *a, None, None, None))
    want = call(jx(q), jx(k), jx(v), jx(do), jnp.asarray(lse.numpy()),
                jnp.asarray(delta.numpy()))
    got = emulate_fused_bwd(q, k, v, do, lse, delta)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert cs.bwd_tolerance_use(g, w, BF16, fused=True) <= 1.0, label


# ---- the turnstile: which key tiles visit a query tile, and in what order


def _key_tile_range(t, j, causal, window, shift):
    """The query tiles (their first rows) key tile j visits: the ranges of
    bwd_dkv_kernel / bwd_fused_mma_kernel in csrc/flash_bwd*.cu."""
    j0 = j * TILE
    j_last = min(j0 + TILE, t) - 1
    i_begin = min(max(j0 - shift, 0), t) if causal else 0
    i_end = min(max(j_last + window - shift, 0), t) if window is not None else t
    i_first = (i_begin // TILE) * TILE if i_begin < i_end else i_end
    return list(range(i_first, i_end, TILE))


def _first_key_tile_of(i0, window, shift):
    """csrc/flash_bwd.cu first_key_tile_of."""
    if window is None:
        return 0
    x = i0 - window + shift
    return 0 if x < TILE - 1 else (x - (TILE - 1)) // TILE + 1


def _block_order(t, j, g, causal, window, shift):
    """The (head in group, first row) of each query tile the fused block of
    key tile j visits, in its order: latest position first, then heads."""
    tiles = _key_tile_range(t, j, causal, window, shift)
    return [(ig, i0) for i0 in reversed(tiles) for ig in range(g)]


_GEOMETRIES = [
    (t, causal, window, shift)
    for t in (64, 100, 256, 300)
    for causal in (True, False)
    for window in (None, 1, 50, 64, 130)
    for shift in (-300, -40, 0, 37, 64, 500)
]


@pytest.mark.parametrize("t,causal,window,shift", _GEOMETRIES[::3] + [
    (2048, True, None, 0), (2048, True, 512, 0), (4096, True, 1536, 4096)])
def test_turnstile_turns_count_the_earlier_visitors(t, causal, window, shift):
    """For every query tile, the turn each visiting key tile waits for (its
    index less first_key_tile_of) is exactly the number of visitors before
    it, so the adds land in ascending key-tile order and none waits for a
    visit that never comes."""
    n_kt = -(-t // TILE)
    visitors = {}
    for j in range(n_kt):
        for i0 in _key_tile_range(t, j, causal, window, shift):
            visitors.setdefault(i0, []).append(j)
    for i0, js in visitors.items():
        assert js == list(range(js[0], js[0] + len(js))), (i0, js)
        for rank, j in enumerate(js):
            assert j - _first_key_tile_of(i0, window, shift) == rank, (i0, j)


def _schedule(t, g, causal, window, shift, slots, partials):
    """Run the fused blocks of one (batch row, kv head) as the card would:
    blocks start in ticket order into `slots` resident places; each steps
    through its query tiles and adds its partial only at its turn. Returns
    the fp32 dq sums [g][n_qt] built in the order the adds land, or raises
    if no resident block can move (a deadlock)."""
    n_kt = -(-t // TILE)
    counter, dq = {}, {}
    queue = [(j, _block_order(t, j, g, causal, window, shift))
             for j in range(n_kt)]
    resident = []
    while queue or resident:
        while queue and len(resident) < slots:
            resident.append(list(queue.pop(0)))
        moved = False
        for blk in list(resident):
            j, order = blk
            if not order:
                resident.remove(blk)
                moved = True
                continue
            ig, i0 = order[0]
            turn = j - _first_key_tile_of(i0, window, shift)
            if counter.get((ig, i0), 0) == turn:
                key = (ig, i0)
                dq[key] = dq.get(key, torch.zeros_like(partials[j][ig][i0]))
                dq[key] = dq[key] + partials[j][ig][i0]
                counter[key] = turn + 1
                order.pop(0)
                moved = True
        if not moved:
            raise RuntimeError("no resident block can move")
    return dq


@pytest.mark.parametrize("causal,window,shift", [
    (True, None, 0), (True, 50, 0), (False, 64, -30), (True, None, 37)])
def test_any_schedule_finishes_and_gives_the_same_dq_bits(causal, window,
                                                          shift):
    t, g = 300, 2
    rng = np.random.default_rng(7)
    n_kt = -(-t // TILE)
    partials = [[{i0: torch.from_numpy(
        rng.standard_normal((TILE, 8)).astype(np.float32))
        for i0 in range(0, t, TILE)} for _ in range(g)] for _ in range(n_kt)]
    runs = [_schedule(t, g, causal, window, shift, slots, partials)
            for slots in (1, 2, 3, n_kt)]
    for run in runs[1:]:
        assert run.keys() == runs[0].keys()
        for key in run:
            assert torch.equal(run[key], runs[0][key]), key


def test_turnstile_grows_with_t_not_with_t_squared():
    assert tflash.fused_turnstile_len(2, 32, 2048) == 2 * 32 * 32 + 1
    assert tflash.fused_turnstile_len(1, 32, 131072) == 32 * 2048 + 1
    assert tflash.fused_turnstile_len(1, 4, 100) == 4 * 2 + 1


def _fused_whole(i0, j0, t, causal, window, shift, segments):
    """bwd_fused_mma_kernel's `whole`: the query tile sees the key tile whole."""
    return (i0 + TILE <= t and j0 + TILE <= t and not segments
            and (not causal or i0 + shift >= j0 + TILE - 1)
            and (window is None or i0 + TILE - 1 + shift - window < j0))


@pytest.mark.parametrize("t,causal,window,shift", _GEOMETRIES[1::4])
def test_mask_skip_only_on_tiles_every_row_sees_whole(t, causal, window, shift):
    mask = tflash._mask(t, t, "cpu", causal, window, None, None, shift, 0)[
        0, 0, 0]
    for j in range(-(-t // TILE)):
        for i0 in _key_tile_range(t, j, causal, window, shift):
            if _fused_whole(i0, j * TILE, t, causal, window, shift, False):
                assert mask[i0:i0 + TILE, j * TILE:(j + 1) * TILE].all()
