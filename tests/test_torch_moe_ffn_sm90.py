"""The Hopper core of the bf16 expert FFN (``csrc/moe_ffn_sm90.cuh``: B5, the
aligned kernel, B6, the gather kernel, and B7, the gather + combine kernel)
emulated on the CPU.

The core cannot run here, so its arithmetic is written out in PyTorch, as
the kernels do it, and held to the MoE rule of ``chip_smoke.py`` (bf16:
``|err| <= 1e-6 + 2^-7 |want| + 2^-8 max_row |want|``) against the port's
plain versions and against JAX's Pallas kernels in interpret mode, on the
layout of 128-row tiles the core takes:

- per 128-row tile of one expert, g = A Wg and u = A Wu summed in fp32 one
  64-deep k-slice of h after another; the hidden ``silu(g) * u`` rounded to
  bf16 (the gate-up launch writes it to device memory); y = hidden Wd summed
  one 64-deep k-slice of i after another (the down launch);
- B5: ``y * prob`` rounded once to bf16; a tile whose first row is padding
  comes out as zeros;
- B6: rows gathered from ``x`` by ``pair_src`` (pad rows zero), the prob
  read as ``probs[pair_src]``, then B5's epilogue: on one routing its bits
  are B5's;
- B7: each real row's ``y * prob`` added in fp32 into its token's row, then
  one cast to bf16.

Also mirrored from the kernel's index arithmetic: the block schedule (every
real tile and column block visited once, all-padding tiles skipped, tiles
of one expert next to each other) and the row pieces the gathering
producer writes (the same places as TMA's 128-byte swizzle).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from d9d_tpu.ops import moe as jmoe
from d9d_tpu.ops import moe_pallas as jmp
from d9d_tpu_torch.ops import moe as tmoe
from d9d_tpu_torch.ops import moe_ffn as tmf

torch.set_num_threads(1)

_CORE = (pathlib.Path(tmf.__file__).resolve().parent.parent / "csrc"
         / "moe_ffn_sm90.cuh").read_text()


def _core_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CORE).group(1))


BM = _core_constant("BM")        # rows per tile
BK = _core_constant("BK")        # k-slice
# output columns per block of each launch
BN = {"gate_up": _core_constant("BN_GATE_UP"),
      "down": _core_constant("BN_DOWN")}
PANEL = _core_constant("PANEL")  # columns of one weight box
BF16 = torch.bfloat16


def _tiles(pair_src):
    """(tile, rows, real) of the layout: real is False for a tile whose
    first row is padding."""
    for t in range(pair_src.shape[0] // BM):
        rows = slice(t * BM, (t + 1) * BM)
        yield t, rows, bool(pair_src[t * BM] >= 0)


def _silu(v):
    return v / (1.0 + torch.exp(-v))


def _emulate_y(a, gid, pair_src, wg, wu, wd, drop_last_slice=False):
    """fp32 ``y [m_pad, h]`` before the prob scale, per real tile in the
    core's order of sums; all-padding tiles stay zero."""
    m_pad, h = a.shape
    inter = wg.shape[2]
    y = torch.zeros((m_pad, h), dtype=torch.float32)
    k_end = h - BK if drop_last_slice else h
    for t, rows, real in _tiles(pair_src):
        if not real:
            continue
        e = int(gid[t])
        at = a[rows].float()
        g = torch.zeros((BM, inter))
        u = torch.zeros((BM, inter))
        for k0 in range(0, k_end, BK):
            g = g + at[:, k0:k0 + BK] @ wg[e, k0:k0 + BK].float()
            u = u + at[:, k0:k0 + BK] @ wu[e, k0:k0 + BK].float()
        hidden = (_silu(g) * u).to(BF16).float()
        yt = torch.zeros((BM, h))
        for k0 in range(0, inter, BK):
            yt = yt + hidden[:, k0:k0 + BK] @ wd[e, k0:k0 + BK].float()
        y[rows] = yt
    return y


def emulate_aligned(a, probs, gid, pair_src, wg, wu, wd, **kw):
    """B5 on the core: ``y * prob`` rounded once; zeros in padding tiles."""
    y = _emulate_y(a, gid, pair_src, wg, wu, wd, **kw)
    return (y * probs[:, None].float()).to(BF16)


def emulate_gather(x, probs_flat, gid, pair_src, wg, wu, wd, *, top_k, **kw):
    """B6 on the core, gathering as the kernels do and not through the
    wrapper's helper: in each real tile the gate-up block copies row r from
    token ``pair_src[r] // top_k`` and zero-fills a pad row; the down block
    reads the prob as ``probs_flat[pair_src[r]]``, 0 for a pad row; then
    B5's products and epilogue. All-padding tiles are skipped."""
    m_pad, h = pair_src.shape[0], x.shape[1]
    a = torch.zeros((m_pad, h), dtype=x.dtype)
    pr = torch.zeros(m_pad)
    for _t, rows, real in _tiles(pair_src):
        if not real:
            continue
        src = pair_src[rows].to(torch.int64)
        ok = src >= 0
        a_t = torch.zeros((BM, h), dtype=x.dtype)
        a_t[ok] = x[src[ok] // top_k]
        p_t = torch.zeros(BM)
        p_t[ok] = probs_flat.float()[src[ok]]
        a[rows], pr[rows] = a_t, p_t
    y = _emulate_y(a, gid, pair_src, wg, wu, wd, **kw)
    return (y * pr[:, None]).to(BF16)


def emulate_gather_combine(x, probs_flat, gid, pair_src, wg, wu, wd, *,
                           top_k, **kw):
    """B7 on the core: rows gathered by pair_src (pad rows zero), each real
    row's ``y * prob`` added in fp32 into its token's row (tiles in launch
    order), one cast."""
    a, _ = tmf._gathered_rows(x, probs_flat, pair_src, top_k)
    y = _emulate_y(a, gid, pair_src, wg, wu, wd, **kw)
    out = torch.zeros(x.shape, dtype=torch.float32)
    for _t, rows, real in _tiles(pair_src):
        if not real:
            continue
        src = pair_src[rows].to(torch.int64)
        ok = src >= 0
        pr = probs_flat.float()[src[ok]]
        out.index_add_(0, src[ok] // top_k, y[rows][ok] * pr[:, None])
    return out.to(BF16)


# ---------------------------------------------------------------------------
# routings: (N, K, E, ids), every token's K experts distinct


def _route(case, rng):
    if case == "empty_expert":  # expert 2 gets no row
        n, k, e = 96, 2, 4
        ids = np.stack([rng.choice([0, 1, 3], k, replace=False)
                        for _ in range(n)])
    elif case == "one_row_in_an_expert":  # expert 3: token 0 only
        n, k, e = 80, 2, 4
        ids = np.stack([rng.choice(3, k, replace=False) for _ in range(n)])
        ids[0, 1] = 3
    elif case == "group_ends_on_tile_edge":  # expert 0: exactly BM rows
        n, k, e = BM, 2, 4
        ids = np.stack([[0, rng.integers(1, e)] for _ in range(n)])
    elif case == "nk_not_multiple_of_block_m":
        n, k, e = 100, 3, 4
        ids = np.stack([rng.choice(e, k, replace=False) for _ in range(n)])
    elif case == "all_padding_tiles":  # every group a few rows: 4 tiles
        n, k, e = 24, 1, 4             # of real rows, 1 + 4 of padding
        ids = rng.integers(0, e, size=(n, 1))
    else:
        raise AssertionError(case)
    return n, k, e, ids.astype(np.int32)


CASES = ("empty_expert", "one_row_in_an_expert", "group_ends_on_tile_edge",
         "nk_not_multiple_of_block_m", "all_padding_tiles")


def _problem(case, seed=0, h=128, inter=192):
    """bf16 tokens, weights (variance 1/(3 fan_in), as chip_smoke's) and a
    routing; inter = 192 and h = 128 leave the core's last column blocks
    part-filled."""
    rng = np.random.default_rng(seed)
    n, k, e, ids = _route(case, rng)
    x = rng.standard_normal((n, h)).astype(np.float32)

    def uni(shape, fan_in):
        return (rng.uniform(-1, 1, shape) * fan_in ** -0.5).astype(np.float32)

    w = (uni((e, h, inter), h), uni((e, h, inter), h), uni((e, inter, h), inter))
    probs = (rng.random((n, k)) + 0.1).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    ts = tmoe.sort_tokens_by_expert(torch.from_numpy(ids).long(), e)
    js = jmoe.sort_tokens_by_expert(jnp.asarray(ids), e)
    tx = torch.from_numpy(x).to(BF16)
    tw = [torch.from_numpy(v).to(BF16) for v in w]
    return x, w, probs, ids, ts, js, tx, tw, k, e


def _use(got, want):
    return chip_smoke.moe_tolerance_use(got, want, BF16)


@pytest.mark.parametrize("case", CASES)
def test_aligned_core_emulation_within_the_rule(case):
    x, w, probs, _ids, ts, js, tx, tw, k, e = _problem(case, seed=1)
    meta = tmf.aligned_metadata(ts, e, BM)
    pf = torch.from_numpy(probs).reshape(-1)
    a, pa = tmf._gathered_rows(tx, pf, meta.pair_src, k)
    got = emulate_aligned(a, pa, meta.gid, meta.pair_src, *tw)
    plain = tmf.moe_ffn_aligned_plain(a, pa, meta.gid, meta.pair_src, *tw)
    assert got.shape == plain.shape == (meta.m_pad, x.shape[1])
    assert _use(got, plain) <= 1.0

    jmeta = jmp.aligned_metadata(js, e, BM)
    np.testing.assert_array_equal(np.asarray(jmeta.pair_src),
                                  meta.pair_src.numpy())
    jw = [jnp.asarray(v).astype(jnp.bfloat16) for v in w]
    want = jmp._fused_ffn_call(
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(pa.numpy())[:, None], jmeta.gid, *jw, block_m=BM,
        interpret=True)
    assert _use(got, torch.from_numpy(np.array(want.astype(jnp.float32))))\
        <= 1.0
    # all-padding tiles come out as zeros
    pad = [rows for _t, rows, real in _tiles(meta.pair_src) if not real]
    assert pad, "the layout of a routing always ends in padding tiles"
    for rows in pad:
        assert not got[rows].float().any()


@pytest.mark.parametrize("case", CASES)
def test_gather_core_emulation_within_the_rule(case):
    x, w, probs, _ids, ts, js, tx, tw, k, e = _problem(case, seed=4)
    meta = tmf.aligned_metadata(ts, e, BM)
    pf = torch.from_numpy(probs).reshape(-1)
    got = emulate_gather(tx, pf, meta.gid, meta.pair_src, *tw, top_k=k)
    plain = tmf.moe_ffn_gather_plain(tx, pf, meta.gid, meta.pair_src, *tw,
                                     top_k=k)
    assert got.shape == plain.shape == (meta.m_pad, x.shape[1])
    assert _use(got, plain) <= 1.0

    jmeta = jmp.aligned_metadata(js, e, BM)
    jw = [jnp.asarray(v).astype(jnp.bfloat16) for v in w]
    want = jmp._fused_gather_call(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(probs).reshape(-1, 1),
        jmeta.gid, jmeta.pair_src, *jw, block_m=BM, top_k=k, interpret=True)
    assert _use(got, torch.from_numpy(np.array(want.astype(jnp.float32))))\
        <= 1.0
    # the down launch writes the zeros of all-padding tiles (y is allocated
    # uninitialised)
    for _t, rows, real in _tiles(meta.pair_src):
        if not real:
            assert not got[rows].float().any()


@pytest.mark.parametrize("case", CASES)
def test_gather_core_emulation_equals_aligned_bit_for_bit(case):
    """B6's own gather (rows by token, probs read through pair_src, tile by
    tile) builds the aligned rows and probs that the plain gather version
    builds for B5's buffer, so on one routing the emulated B6 gives the
    emulated B5's bits, as chip_smoke requires of the kernels."""
    _x, _w, probs, _ids, ts, _js, tx, tw, k, e = _problem(case, seed=5)
    meta = tmf.aligned_metadata(ts, e, BM)
    pf = torch.from_numpy(probs).reshape(-1)
    a, pa = tmf._gathered_rows(tx, pf, meta.pair_src, k)
    aligned = emulate_aligned(a, pa, meta.gid, meta.pair_src, *tw)
    gather = emulate_gather(tx, pf, meta.gid, meta.pair_src, *tw, top_k=k)
    assert torch.equal(gather, aligned)


@pytest.mark.parametrize("case", CASES)
def test_gather_combine_core_emulation_within_the_rule(case):
    x, w, probs, _ids, ts, js, tx, tw, k, e = _problem(case, seed=2)
    meta = tmf.aligned_metadata(ts, e, BM)
    pf = torch.from_numpy(probs).reshape(-1)
    got = emulate_gather_combine(tx, pf, meta.gid, meta.pair_src, *tw,
                                 top_k=k)
    plain = tmf.moe_ffn_gather_combine_plain(tx, pf, meta.gid, meta.pair_src,
                                             *tw, top_k=k)
    assert got.shape == plain.shape == x.shape
    assert _use(got, plain) <= 1.0

    jmeta = jmp.aligned_metadata(js, e, BM)
    jw = [jnp.asarray(v).astype(jnp.bfloat16) for v in w]
    want = jmp._fused_gather_combine_call(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(probs).reshape(-1, 1),
        jmeta.gid, jmeta.pair_src, *jw, block_m=BM, top_k=k, interpret=True)
    assert _use(got, torch.from_numpy(np.array(want.astype(jnp.float32))))\
        <= 1.0


def test_a_lost_k_slice_breaks_the_rule():
    """Negative control: the emulation without the last 64-deep slice of h
    in g and u (a stage the pipeline lost) fails the rule."""
    _x, _w, probs, _ids, ts, _js, tx, tw, k, e = _problem(
        "nk_not_multiple_of_block_m", seed=3)
    meta = tmf.aligned_metadata(ts, e, BM)
    pf = torch.from_numpy(probs).reshape(-1)
    a, pa = tmf._gathered_rows(tx, pf, meta.pair_src, k)
    plain = tmf.moe_ffn_aligned_plain(a, pa, meta.gid, meta.pair_src, *tw)
    lost = emulate_aligned(a, pa, meta.gid, meta.pair_src, *tw,
                           drop_last_slice=True)
    assert _use(lost, plain) > 10.0


# ---------------------------------------------------------------------------
# the kernel's index arithmetic, mirrored


def _schedule(pair_src, n_total, bn):
    """The blocks of one launch in launch order, as ``ffn_body`` decodes
    ``blockIdx.x``: (tile, first column, columns) of each block that works;
    all-padding tiles read nothing."""
    n_col_blocks = -(-n_total // bn)
    n_tiles = pair_src.shape[0] // BM
    out = []
    for b in range(n_tiles * n_col_blocks):
        tile, n0 = b // n_col_blocks, (b % n_col_blocks) * bn
        panels = min(bn // PANEL, (n_total - n0) // PANEL)
        if pair_src[tile * BM] >= 0:
            out.append((tile, n0, panels * PANEL))
    return out


@pytest.mark.parametrize("launch", ["gate_up", "down"])
@pytest.mark.parametrize("n_total", [64, 128, 192, 320, 768, 2048])
def test_schedule_visits_every_real_tile_and_column_once(n_total, launch):
    rng = np.random.default_rng(n_total)
    ids = rng.integers(0, 8, size=(300, 1)).astype(np.int64)
    ids[:40] = 5  # one large group, over a tile edge
    sort = tmoe.sort_tokens_by_expert(torch.from_numpy(ids), 8)
    meta = tmf.aligned_metadata(sort, 8, BM)
    blocks = _schedule(meta.pair_src, n_total, BN[launch])
    real = [t for t, _rows, ok in _tiles(meta.pair_src) if ok]
    cover = np.zeros((meta.gid.shape[0], n_total), dtype=np.int64)
    for tile, n0, width in blocks:
        cover[tile, n0:n0 + width] += 1
    assert (cover[real] == 1).all()
    assert cover.sum() == len(real) * n_total  # nothing on padding tiles
    # the tiles of one expert run next to each other, experts in order
    experts = [int(meta.gid[t]) for t, _n0, _w in blocks]
    assert experts == sorted(experts)


def test_gathered_pieces_land_where_tma_swizzles_them():
    """B7's producer: thread pt copies piece pt % 8 of rows pt / 8 + 16 j
    to r * 128 + ((c ^ (r & 7)) * 16); TMA's 128-byte swizzle puts byte
    offset o at o ^ (((o >> 7) & 7) << 4). The two agree, and the 128
    threads fill the 16 KB tile once."""
    seen = set()
    for pt in range(128):
        c, r0 = pt & 7, pt >> 3
        swz = r0 * 128 + ((c ^ (r0 & 7)) * 16)
        for j in range(8):
            r = r0 + 16 * j
            place = swz + j * 16 * 128
            plain = r * 128 + c * 16
            assert place == plain ^ (((plain >> 7) & 7) << 4)
            seen.add(place)
    assert seen == set(range(0, BM * BK * 2, 16))
