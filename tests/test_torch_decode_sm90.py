"""The arithmetic and the key split of the bf16 decode core designed for the
H100 (``csrc/attn_decode_sm90.cuh``: B8 for g*T <= 16 rows per kv head, B9
for every bf16 call) against the plain versions and the JAX Pallas decode
kernels, under the decode rule of ``chip_smoke.py`` (``ATOL``, ``RTOL``,
``ROW_RTOL``, ``LSE_TOL``).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against ``flash_decode_plain`` / ``flash_decode_paged_plain``. What it
computes differently from them, and what :func:`emulate_decode_sm90`
writes out in plain PyTorch:

- a cluster of n blocks per (batch row, kv head, 16-row tile); block c takes
  the 64-key tiles [first + count*c // n, first + count*(c+1) // n) of the
  rows' own visible range (:func:`block_tiles`);
- warp w of a block takes keys [16w, 16w + 16) of each of its tiles in
  ascending order, with its own online softmax in log2 units (exp2);
- logits of the bf16 inputs summed in fp32; int8 pools: q . k of the int8
  values, times the key's scale; p times the value's scale, rounded to bf16
  before p . v (bf16 pools: p rounded to bf16);
- the warps merged in the order 0..3, then the blocks in the order 0..n-1;
  o rounded to bf16 once, lse = m * ln(2) + log(l), a row that sees no key
  written as zeros with lse at the sentinel.

Negative controls (a lost tile, a lost page, a dropped block) must break
the rule at least ``CONTROL_MIN_USE`` times over.
"""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention.pallas_decode import (
    flash_decode_attention as jax_decode,
)
from d9d_tpu_torch.nn.attention import _quantize_rows
from d9d_tpu_torch.ops.attention import decode as tdec

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

BF16 = torch.bfloat16
BM, BN, NW = 16, 64, 4  # rows per cluster, keys per tile, warps per block
WK = BN // NW           # keys per warp and tile
LOG2E = 1.4426950408889634
NEG_BIG = -1e30
CONTROL_MIN_USE = 10.0


# ---------------------------------------------------------------------------
# the kernel's key split


def block_tiles(base, t_lo, t_hi, s, window, n):
    """``[(lo, hi)]`` 64-key tiles of the n blocks of one cluster whose rows
    sit at positions ``base + [t_lo, t_hi]`` (the kernel's range rule)."""
    k_end = min(s, base + t_hi + 1)
    k_begin = max(0, base + t_lo - window + 1) if window is not None else 0
    if k_begin >= k_end:
        return [(0, 0)] * n
    first = k_begin // BN
    count = -(-k_end // BN) - first
    return [(first + count * c // n, first + count * (c + 1) // n)
            for c in range(n)]


def row_token_span(r0, rows, t):
    """Tokens [t_lo, t_hi] the rows of a 16-row tile cover (all tokens
    when the tile spans two heads of the group)."""
    r_last = min(r0 + BM, rows) - 1
    if r0 // t == r_last // t:
        return r0 % t, r_last % t
    return 0, t - 1


# ---------------------------------------------------------------------------
# the emulation


def _visible(pos, keys, s, window, valid_row):
    """[rows, keys] visibility of keys for rows at positions ``pos``."""
    ok = (keys[None, :] <= pos[:, None]) & (keys[None, :] < s) & (pos[:, None] >= 0)
    if window is not None:
        ok &= keys[None, :] > pos[:, None] - window
    if valid_row is not None:
        kc = keys.clamp(max=s - 1)
        ok &= (valid_row[kc] != 0)[None, :] & (keys[None, :] < s)
    return ok


def emulate_decode_sm90(q, k, v, start, *, window=None, kv_valid=None,
                        k_scale=None, v_scale=None, n=1, drop_tile=None,
                        drop_block=None):
    """``(o [B,T,Hq,D] bf16, lse [B,Hq,T])`` as the kernel computes them.

    ``k``/``v`` are the contiguous view ``[B,Hkv,S,D]`` the kernel reads (a
    paged call gathers its pages first: the same values); with
    ``k_scale``/``v_scale [B,Hkv,S]`` they hold int8 values. ``drop_tile``
    (block, local tile) skips one tile of every cluster and ``drop_block``
    leaves one block out of the merge: the negative controls."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    rows = g * t
    scale_log2 = d ** -0.5 * LOG2E
    starts = torch.as_tensor(start).reshape(-1).expand(b).tolist()
    o = torch.zeros((b, t, hq, d))
    lse = torch.zeros((b, hq, t))
    kf, vf = k.float(), v.float()
    qf = q.float()
    for bi in range(b):
        base = int(starts[bi])
        valid_row = None if kv_valid is None else kv_valid[bi]
        for h in range(hkv):
            for r0 in range(0, rows, BM):
                rr = torch.arange(r0, min(r0 + BM, rows))
                pos = base + rr % t
                qh = qf[bi, rr % t, h * g + rr // t]  # [R, D]
                t_lo, t_hi = row_token_span(r0, rows, t)
                parts = []
                for c, (lo, hi) in enumerate(
                        block_tiles(base, t_lo, t_hi, s, window, n)):
                    warps = []
                    for w in range(NW):
                        m = torch.full((len(rr),), NEG_BIG)
                        l = torch.zeros(len(rr))
                        acc = torch.zeros((len(rr), d))
                        for i, tile in enumerate(range(lo, hi)):
                            if drop_tile == (c, i):
                                continue
                            keys = tile * BN + w * WK + torch.arange(WK)
                            kk = keys.clamp(max=s - 1)
                            x = (qh @ kf[bi, h, kk].T) * scale_log2
                            if k_scale is not None:
                                x = x * k_scale[bi, h, kk][None, :]
                            ok = _visible(pos, keys, s, window, valid_row)
                            x = torch.where(ok, x, torch.full_like(x, NEG_BIG))
                            m_new = torch.maximum(m, x.amax(-1))
                            alpha = torch.exp2(m - m_new)
                            p = torch.where(ok, torch.exp2(x - m_new[:, None]),
                                            torch.zeros_like(x))
                            l = alpha * l + p.sum(-1)
                            if v_scale is not None:
                                p = p * v_scale[bi, h, kk][None, :]
                            acc = acc * alpha[:, None] + \
                                p.to(BF16).float() @ vf[bi, h, kk]
                            m = m_new
                        warps.append((m, l, acc))
                    # the block: its warps in the order 0..3
                    mb = torch.stack([x[0] for x in warps]).amax(0)
                    lb = torch.zeros_like(mb)
                    ob = torch.zeros((len(rr), d))
                    for mw, lw, ow in warps:
                        lb = lb + lw * torch.exp2(mw - mb)
                    for mw, lw, ow in warps:
                        ob = ob + ow * torch.exp2(mw - mb)[:, None]
                    if drop_block != c:
                        parts.append((mb, lb, ob))
                # the cluster: its blocks in the order 0..n-1
                mc = torch.stack([x[0] for x in parts]).amax(0)
                wts = [torch.exp2(mp - mc) for mp, _, _ in parts]
                lc = torch.zeros_like(mc)
                for (_, lp, _), wt in zip(parts, wts):
                    lc = lc + lp * wt
                oc = torch.zeros((len(rr), d))
                for (_, _, op), wt in zip(parts, wts):
                    oc = oc + op * wt[:, None]
                out = oc * (1.0 / lc.clamp_min(1e-30))[:, None]
                o[bi, rr % t, h * g + rr // t] = out
                lse[bi, h * g + rr // t, rr % t] = torch.where(
                    lc > 0, mc * math.log(2.0) + torch.log(lc.clamp_min(1e-30)),
                    torch.full_like(lc, NEG_BIG + math.log(1e-30)))
    return o.to(BF16), lse


# ---------------------------------------------------------------------------
# inputs


def _contiguous(b, t, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(BF16) for shape in ((b, t, hq, d), (b, hkv, s, d),
                                       (b, hkv, s, d)))
    return q, k, v


def _paged(b, t, hq, hkv, n_pages, ps, d, seed, quant):
    """Pools [P, Hkv, ps, D] (page 0 the garbage page), a shuffled table in
    which rows 0 and 1 share their first page, int8 pools quantized by the
    port's own rule."""
    rng = np.random.default_rng(seed)
    p_total = b * n_pages + 1
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(np.float32))
    k = torch.from_numpy(
        rng.standard_normal((p_total, hkv, ps, d)).astype(np.float32))
    v = torch.from_numpy(
        rng.standard_normal((p_total, hkv, ps, d)).astype(np.float32))
    table = torch.from_numpy(
        (rng.permutation(p_total - 1)[: b * n_pages] + 1)
        .reshape(b, n_pages).astype(np.int32))
    table[1, 0] = table[0, 0]
    q = q.to(BF16)
    if quant:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
        return q, k, v, ks, vs, table
    return q, k.to(BF16), v.to(BF16), None, None, table


def _gather(pool, table):
    return tdec.gather_pages_heads_major(pool, table)


def _gather_scales(scale, table):
    g = scale[table.long()]  # [B, n, H, ps]
    b, n, h, ps = g.shape
    return g.transpose(1, 2).reshape(b, h, n * ps)


def _assert_within_rule(o, lse, op, lsep):
    assert torch.isfinite(o.float()).all()
    live = lsep > NEG_BIG / 10
    o_t, op_t = o.transpose(1, 2), op.transpose(1, 2)  # [B, Hq, T, D]
    if live.any():
        use = cs.tolerance_use(o_t[live], op_t[live], BF16)
        assert use <= 1.0, use
        assert float((lse[live] - lsep[live]).abs().max()) <= cs.LSE_TOL
    assert bool((o_t[~live] == 0).all())
    assert torch.equal(lse[~live], lsep[~live])


# ---------------------------------------------------------------------------
# tests: the rule's constants, the split, the host rule


def test_the_decode_rule_is_unchanged():
    assert cs.ATOL[BF16] == 1e-6 and cs.RTOL[BF16] == 2e-2
    assert cs.ROW_RTOL[BF16] == 2.0 ** -7 and cs.LSE_TOL == 1e-4
    assert cs.PAGED_LOST_PAGE_MIN_USE == 10.0


S_SPLIT = 320  # five 64-key tiles: splits of 2, 4 and 8 blocks are uneven


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("t", [1, 4])
def test_block_tiles_cover_every_visible_key_once(t, window, n):
    """For every start in 0..S-1 and page sizes 4, 8 and 16: the n blocks'
    tiles hold every key a row of the tile sees exactly once (and every
    page holding one), and no tile lies wholly outside the rows' range."""
    g = 4
    rows = g * t
    for start in range(S_SPLIT):
        for r0 in range(0, rows, BM):
            t_lo, t_hi = row_token_span(r0, rows, t)
            ranges = block_tiles(start, t_lo, t_hi, S_SPLIT, window, n)
            counts = np.zeros(S_SPLIT, np.int64)
            for lo, hi in ranges:
                assert 0 <= lo <= hi
                for tile in range(lo, hi):
                    keys = np.arange(tile * BN, (tile + 1) * BN)
                    counts[keys[keys < S_SPLIT]] += 1
            rr = np.arange(r0, min(r0 + BM, rows))
            pos = start + rr % t
            keys = np.arange(S_SPLIT)
            vis = (keys[None, :] <= pos[:, None])
            if window is not None:
                vis &= keys[None, :] > pos[:, None] - window
            seen = vis.any(0)
            assert (counts[seen] == 1).all(), (start, r0)
            assert (counts <= 1).all()
            for lo, hi in ranges:  # each tile holds a visible key
                for tile in range(lo, hi):
                    assert seen[tile * BN:(tile + 1) * BN].any()
            for ps in (4, 8, 16):
                pages = np.zeros(S_SPLIT // ps, np.int64)
                np.add.at(pages, keys[counts > 0] // ps, 1)
                assert (pages[np.unique(keys[seen] // ps)] == ps).all()


@pytest.mark.parametrize("bh,rows,want", [
    ((8, 8), 4, 4), ((1, 8), 4, 8), ((64, 8), 4, 1), ((8, 8), 16, 4),
    ((2, 8), 32, 8), ((33, 8), 4, 1), ((4, 8), 4, 8),
])
def test_decode_cluster_sizes_from_shapes(bh, rows, want):
    """The largest cluster whose clusters the card holds at once, here
    for a capacity of three blocks on each of 132 SMs (396, 198, 99 and 49
    clusters of 1, 2, 4 and 8 blocks)."""
    capacity = {1: 396, 2: 198, 4: 99, 8: 49}
    b, hkv = bh
    n = tdec.decode_cluster(b, hkv, rows, capacity)
    assert n == want
    assert n in (1, 2, 4, 8)
    assert n == 8 or b * hkv * -(-rows // BM) > capacity[2 * n]


@pytest.mark.parametrize("bh,rows,want", [
    ((8, 8), 4, 2), ((1, 8), 4, 8), ((4, 8), 4, 4), ((64, 8), 4, 1),
])
def test_decode_cluster_runs_in_one_wave(bh, rows, want):
    """With the card's capacity per cluster size (as an H100 reports it for
    two 104 KB blocks an SM: 264, 132, 62 and 30 clusters), the clusters
    never outnumber what it holds at once."""
    capacity = {1: 264, 2: 132, 4: 62, 8: 30}
    b, hkv = bh
    n = tdec.decode_cluster(b, hkv, rows, capacity=capacity)
    assert n == want
    assert n == 1 or b * hkv * -(-rows // BM) <= capacity[n]


# ---------------------------------------------------------------------------
# tests: the emulation under the rule


_CONTIGUOUS = {
    # name: (B, T, Hq, Hkv, S, D, start, keywords)
    "step_spread": (4, 1, 8, 2, 320, 64, [5, 100, 200, 319], {}),
    "step_edges": (8, 1, 8, 2, 320, 64, [0, 63, 64, 65, 127, 128, 255, 319],
                   {}),
    "scalar_start_window": (3, 1, 8, 2, 320, 64, 250, {"window": 70}),
    "kv_valid_bool": (4, 1, 8, 2, 320, 64, [5, 100, 200, 319],
                      {"valid": "bool"}),
    "kv_valid_int32": (4, 1, 8, 2, 320, 64, [5, 100, 200, 319],
                       {"valid": "int32"}),
    "sixteen_rows_t4": (3, 4, 8, 2, 320, 64, [0, 97, 316], {}),
    "g4_d128": (2, 1, 8, 2, 256, 128, [130, 255], {}),
}


def _contiguous_case(name):
    b, t, hq, hkv, s, d, start, kw = _CONTIGUOUS[name]
    q, k, v = _contiguous(b, t, hq, hkv, s, d, seed=len(name))
    kw = dict(kw)
    valid = kw.pop("valid", None)
    if valid is not None:
        # the first rows' dead slots; row 0 has none visible: exact zeros
        pad = torch.tensor([6, 0, 17, 40][:b])
        kv = torch.arange(s)[None, :] >= pad[:, None]
        kw["kv_valid"] = kv if valid == "bool" else kv.to(torch.int32)
    return q, k, v, torch.tensor(start, dtype=torch.int32), kw


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", list(_CONTIGUOUS))
def test_emulated_contiguous_decode_is_within_the_rule(name, n):
    q, k, v, start, kw = _contiguous_case(name)
    window = kw.get("window")
    op, lsep = tdec.flash_decode_plain(
        q, k, v, start=start, window_size=window, kv_valid=kw.get("kv_valid"))
    o, lse = emulate_decode_sm90(q, k, v, start, window=window,
                                 kv_valid=kw.get("kv_valid"), n=n)
    _assert_within_rule(o, lse, op, lsep)
    if "kv_valid" in kw:
        assert bool((o[0] == 0).all())


_PAGED = {
    # name: (T, page size, pages per row, int8, start, window)
    "bf16_ps16": (1, 16, 20, False, [5, 100, 200, 319], None),
    "bf16_ps8_edges": (1, 8, 40, False, [0, 63, 64, 319], None),
    "bf16_ps4_window": (1, 4, 80, False, [7, 150, 230, 300], 60),
    "bf16_t4_sixteen_rows": (4, 16, 20, False, [0, 64, 160, 316], None),
    "int8_ps16": (1, 16, 20, True, [5, 100, 200, 319], None),
    "int8_ps4_edges": (1, 4, 80, True, [0, 63, 65, 319], None),
    "int8_t4_window": (4, 8, 40, True, [3, 90, 191, 316], 50),
}


def _paged_case(name):
    t, ps, n_pages, quant, start, window = _PAGED[name]
    q, k, v, ks, vs, table = _paged(4, t, 8, 2, n_pages, ps, 64,
                                    seed=3 * len(name), quant=quant)
    return q, k, v, ks, vs, table, torch.tensor(start, dtype=torch.int32), \
        window


def _emulate_paged(q, k, v, ks, vs, table, start, window, **kw):
    kc, vc = _gather(k, table), _gather(v, table)
    scales = {}
    if ks is not None:
        scales = dict(k_scale=_gather_scales(ks, table),
                      v_scale=_gather_scales(vs, table))
    return emulate_decode_sm90(q, kc, vc, start, window=window, **scales, **kw)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", list(_PAGED))
def test_emulated_paged_decode_is_within_the_rule(name, n):
    q, k, v, ks, vs, table, start, window = _paged_case(name)
    op, lsep = tdec.flash_decode_paged_plain(
        q, k, v, start=start, page_table=table, k_scale=ks, v_scale=vs,
        window_size=window)
    o, lse = _emulate_paged(q, k, v, ks, vs, table, start, window, n=n)
    _assert_within_rule(o, lse, op, lsep)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_merge_order_is_fixed(n):
    """The cluster's result, merged in the order 0..n-1, is the same bits on
    a second run, and within the rule of the one-block result."""
    q, k, v, start, kw = _contiguous_case("step_edges")
    o1, lse1 = emulate_decode_sm90(q, k, v, start, n=n)
    o2, lse2 = emulate_decode_sm90(q, k, v, start, n=n)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    o0, lse0 = emulate_decode_sm90(q, k, v, start, n=1)
    _assert_within_rule(o1, lse1, o0, lse0)


# ---------------------------------------------------------------------------
# tests: against the JAX Pallas kernels in interpret mode


def _jax_contiguous(q, k, v, start, window, valid):
    out = jax.jit(lambda q, k, v, s, kv: jax_decode(
        q, k, v, start=s, window_size=window, kv_valid=kv, block_kv=32,
        interpret=True))(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy()),
        jnp.asarray(v.float().numpy()), jnp.asarray(start.numpy()),
        None if valid is None else jnp.asarray(valid.numpy()))
    return torch.from_numpy(np.asarray(out))


def _jax_paged(q, k, v, ks, vs, table, start, window):
    opt = (lambda x: None if x is None else jnp.asarray(x.numpy()))
    kv = (lambda x: jnp.asarray(x.numpy() if x.dtype == torch.int8
                                else x.float().numpy()))
    out = jax.jit(lambda q, k, v, s, tb, ks, vs: jax_decode(
        q, k, v, start=s, window_size=window, page_table=tb, k_scale=ks,
        v_scale=vs, interpret=True))(
        jnp.asarray(q.float().numpy()), kv(k), kv(v), jnp.asarray(start.numpy()),
        jnp.asarray(table.numpy()), opt(ks), opt(vs))
    return torch.from_numpy(np.asarray(out))


@pytest.mark.parametrize("name", ["step_edges", "scalar_start_window",
                                  "kv_valid_bool", "sixteen_rows_t4"])
def test_emulated_contiguous_decode_matches_pallas_interpret(name):
    q, k, v, start, kw = _contiguous_case(name)
    valid = kw.get("kv_valid")
    want = _jax_contiguous(q, k, v, start, kw.get("window"),
                           None if valid is None else valid.to(torch.int32))
    o, _ = emulate_decode_sm90(q, k, v, start, window=kw.get("window"),
                               kv_valid=valid, n=4)
    assert cs.tolerance_use(o, want, BF16) <= 1.0


@pytest.mark.parametrize("name", ["bf16_ps8_edges", "bf16_t4_sixteen_rows",
                                  "int8_ps16", "int8_t4_window"])
def test_emulated_paged_decode_matches_pallas_interpret(name):
    q, k, v, ks, vs, table, start, window = _paged_case(name)
    want = _jax_paged(q, k, v, ks, vs, table, start, window)
    o, _ = _emulate_paged(q, k, v, ks, vs, table, start, window, n=4)
    assert cs.tolerance_use(o, want, BF16) <= 1.0


# ---------------------------------------------------------------------------
# tests: negative controls


def _rows_use(o, op, lsep):
    live = lsep > NEG_BIG / 10
    return cs.tolerance_use(o.transpose(1, 2)[live], op.transpose(1, 2)[live],
                            BF16)


@pytest.mark.parametrize("control", ["lost_tile", "dropped_block"])
@pytest.mark.parametrize("name", ["step_spread", "sixteen_rows_t4"])
def test_a_lost_tile_or_block_breaks_the_rule(name, control):
    q, k, v, start, kw = _contiguous_case(name)
    op, lsep = tdec.flash_decode_plain(q, k, v, start=start)
    bad = {"lost_tile": dict(drop_tile=(1, 0)),
           "dropped_block": dict(drop_block=1)}[control]
    o, _ = emulate_decode_sm90(q, k, v, start, n=2, **bad)
    assert _rows_use(o, op, lsep) >= CONTROL_MIN_USE


@pytest.mark.parametrize("name", ["bf16_ps16", "int8_ps4_edges"])
def test_a_lost_page_breaks_the_rule(name):
    q, k, v, ks, vs, table, start, window = _paged_case(name)
    op, lsep = tdec.flash_decode_paged_plain(
        q, k, v, start=start, page_table=table, k_scale=ks, v_scale=vs,
        window_size=window)
    bad = table.clone()
    bad[3, 1] = 0  # row 3 reads its second page from the garbage page
    o, _ = _emulate_paged(q, k, v, ks, vs, bad, start, window, n=2)
    assert _rows_use(o, op, lsep) >= CONTROL_MIN_USE


# ---------------------------------------------------------------------------
# tests: what the wrappers hand the kernel as it comes


def test_start_is_read_as_it_comes():
    shared = torch.tensor(7, dtype=torch.int32)
    got, stride = tdec._start_view(shared, 4, shared.device)
    assert got is shared and stride == 0
    per_row = torch.arange(4, dtype=torch.int32)
    got, stride = tdec._start_view(per_row, 4, per_row.device)
    assert got is per_row and stride == 1
    got, stride = tdec._start_view(5, 4, per_row.device)
    assert stride == 0 and int(got) == 5 and got.dtype == torch.int32
    got, stride = tdec._start_view(per_row.long(), 4, per_row.device)
    assert stride == 1 and got.dtype == torch.int32
    assert torch.equal(got, per_row)


@pytest.mark.parametrize("dtype,nbytes", [
    (torch.bool, 1), (torch.uint8, 1), (torch.int32, 4), (torch.int64, 1),
])
def test_kv_valid_is_read_as_it_comes(dtype, nbytes):
    """bool and int32 validity go to the kernel as they are — a
    [B, 1, 1, S] mask's ``[:, 0, 0, :]`` view with its row stride — other
    types as a bool copy."""
    mask = (torch.arange(12)[None, :] >= torch.tensor([0, 3])[:, None])
    view = mask.to(dtype)[:, None, None, :][:, 0, 0, :]
    got, width, row_stride = tdec._valid_view(view, 2, 12, view.device)
    assert width == nbytes and got.stride(-1) == 1
    assert row_stride == got.stride(0)
    if dtype in (torch.bool, torch.int32):
        assert got.dtype == dtype
        assert got.data_ptr() == view.data_ptr()
    else:
        assert got.dtype == torch.bool
    assert torch.equal(got != 0, mask)


def test_unaligned_one_byte_flags_go_as_int32():
    """Rows of one-byte flags that do not start 4-byte aligned (the kernel
    copies flags 4 bytes at a time) are handed over as int32."""
    mask = torch.arange(13)[None, :] >= torch.tensor([0, 3])[:, None]
    view = mask[:, 1:]  # starts one byte into the storage
    got, width, row_stride = tdec._valid_view(view, 2, 12, view.device)
    assert width == 4 and got.dtype == torch.int32
    assert row_stride == got.stride(0) and torch.equal(got != 0, view)
