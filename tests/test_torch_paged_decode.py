"""The paged flash-decode path of the port (``ops/attention/decode.py``
``flash_decode_attention(page_table=...)`` and the paged cache of
``nn/attention.py``) vs the JAX package on the CPU.

Kernel level: the JAX package's Pallas paged decode kernel in interpret mode
(``flash_decode_attention(page_table=..., interpret=True)``) against the
port's wrapper, which on the CPU takes the kernel's plain version
(``flash_decode_paged_plain``). Inputs from a numpy seed; page tables
shuffled, non-monotone and shared between rows. Tolerances:

- float32 pools: rtol=1e-5, atol=2e-5 (online softmax page by page vs one
  pass over the gathered cache);
- int8 pools: the same — both sides widen ``int8 * scale`` in float32 and
  differ only in the order of sums, so the quantization error is not part of
  the comparison;
- bfloat16 pools: one bf16 step of the element, ``2^-7 * |want| + 1e-6``
  (both sides accumulate in float32 and round the output once).

Module level: the port's ``GroupedQueryAttention`` writing a
``PagedDecodeCache`` vs the JAX module writing its paged cache leaves, six
single-token steps, fp32 and int8 pools: outputs, float pools and scales
within the fp32 tolerance, int8 values at most one quantization step apart
(the projections feeding them differ in float rounding; the quantizer itself
is held bitwise to the reference's).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.nn.attention import GroupedQueryAttention as JaxGQA
from d9d_tpu.nn.attention import _quantize_rows as jax_quantize_rows
from d9d_tpu.ops import compute_rope_frequencies, make_rope_cos_sin
from d9d_tpu.ops.attention.eager import eager_sdpa as jax_eager
from d9d_tpu.ops.attention.pallas_decode import (
    flash_decode_attention as jax_decode,
)
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.nn import GroupedQueryAttention, PagedDecodeCache
from d9d_tpu_torch.nn.attention import _quantize_rows
from d9d_tpu_torch.nn.decode_flags import PAGED_SCALE_SUFFIX
from d9d_tpu_torch.nn.sdpa import SdpaEagerConfig, build_sdpa_backend
from d9d_tpu_torch.ops.attention import decode as tdec

TOL = dict(rtol=1e-5, atol=2e-5)
B, HQ, HKV, D = 3, 4, 2, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _quantize_np(x):
    """Symmetric per-slot int8 of ``x [..., D]`` (the rule of
    ``_quantize_rows``), in numpy: (int8, f32 scale)."""
    scale = np.abs(x).max(axis=-1) / np.float32(127.0)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.round(x / safe[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _problem(seed, *, ps, n_pages, t, dtype="float32", quant=False):
    """Random pools ``[P, Hkv, ps, D]`` and a shuffled page table in which
    rows 0 and 2 share their first page (a prefix hit) and row 1 reads its
    pages in descending order."""
    rng = np.random.default_rng(seed)
    p_total = B * n_pages + 2
    q = rng.standard_normal((B, t, HQ, D)).astype(np.float32)
    k = rng.standard_normal((p_total, HKV, ps, D)).astype(np.float32)
    v = rng.standard_normal((p_total, HKV, ps, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, p_total))[: B * n_pages]
    table = ids.reshape(B, n_pages).astype(np.int32)
    table[1] = np.sort(table[1])[::-1]
    table[2, 0] = table[0, 0]
    out = {"q": q, "k": k, "v": v, "table": table, "ks": None, "vs": None}
    if quant:
        out["k"], out["ks"] = _quantize_np(k)
        out["v"], out["vs"] = _quantize_np(v)
    if dtype == "bfloat16":
        for key in ("q", "k", "v"):
            out[key] = np.asarray(jnp.asarray(out[key], jnp.bfloat16))
    return out


@pytest.fixture(scope="module")
def jax_paged():
    """The JAX paged decode in interpret mode, jitted once per signature."""
    cache = {}

    def run(pb, start, *, window=None, sinks=None):
        key = (pb["q"].shape, pb["k"].shape, str(pb["k"].dtype),
               pb["ks"] is not None, window, sinks is not None)
        if key not in cache:
            def fn(q, k, v, start, table, ks, vs, sinks):
                return jax_decode(
                    q, k, v, start=start, window_size=window, sinks=sinks,
                    page_table=table, k_scale=ks, v_scale=vs, interpret=True,
                )
            cache[key] = jax.jit(fn)
        opt = (lambda x: None if x is None else jnp.asarray(x))
        return np.asarray(cache[key](
            jnp.asarray(pb["q"]), jnp.asarray(pb["k"]), jnp.asarray(pb["v"]),
            jnp.asarray(start, jnp.int32), jnp.asarray(pb["table"]),
            opt(pb["ks"]), opt(pb["vs"]), opt(sinks),
        ).astype(jnp.float32))

    return run


def _port(pb, start, *, window=None, sinks=None):
    dt = torch.bfloat16 if pb["q"].dtype == jnp.bfloat16 else None

    def conv(x):
        if x is None:
            return None
        if dt is not None and x.dtype == jnp.bfloat16:
            return _t(x.astype(np.float32)).to(dt)
        return _t(x)

    return tdec.flash_decode_attention(
        conv(pb["q"]), conv(pb["k"]), conv(pb["v"]), start=_t(start),
        window_size=window, sinks=None if sinks is None else _t(sinks),
        page_table=_t(pb["table"]), k_scale=conv(pb["ks"]),
        v_scale=conv(pb["vs"]),
    )


_CASES = {
    "step_ps4": dict(ps=4, n_pages=6, t=1, start=[0, 13, 23]),
    "step_ps8_per_row": dict(ps=8, n_pages=4, t=1, start=[31, 7, 16]),
    "chunk_t3": dict(ps=4, n_pages=6, t=3, start=[2, 17, 20]),
    "window": dict(ps=4, n_pages=6, t=1, start=[5, 22, 12], window=6),
    "sinks": dict(ps=8, n_pages=4, t=1, start=[9, 30, 1], sinks=True),
    "window_sinks_chunk": dict(ps=4, n_pages=6, t=2, start=[3, 21, 14],
                               window=9, sinks=True),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", list(_CASES))
def test_paged_decode_matches_pallas_interpret(case, quant, jax_paged):
    spec = dict(_CASES[case])
    start = np.asarray(spec.pop("start"), np.int32)
    window = spec.pop("window", None)
    sinks = None
    if spec.pop("sinks", False):
        sinks = np.random.default_rng(5).standard_normal(HQ).astype(
            np.float32)
    pb = _problem(1, quant=quant, **spec)
    want = jax_paged(pb, start, window=window, sinks=sinks)
    before = tdec.flash_decode_paged.plain_calls
    got = _port(pb, start, window=window, sinks=sinks)
    assert tdec.flash_decode_paged.plain_calls == before + 1
    assert got.shape == (B, spec["t"], HQ, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_decode_bf16_pools_match_pallas_interpret(jax_paged):
    start = np.asarray([6, 29, 17], np.int32)
    sinks = np.random.default_rng(6).standard_normal(HQ).astype(np.float32)
    pb = _problem(2, ps=8, n_pages=4, t=1, dtype="bfloat16")
    want = jax_paged(pb, start, window=12, sinks=sinks)
    got = _port(pb, start, window=12, sinks=sinks)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0**-7 * np.abs(want) + 1e-6).all(), err.max()


def _ref_lse(pb, start, t, ps):
    """Independent numpy logsumexp over the visible slots of the gathered
    (dequantized) cache, [B, Hq, T]."""
    g = HQ // HKV
    k = pb["k"].astype(np.float64)
    if pb["ks"] is not None:
        k = k * pb["ks"][..., None]
    out = np.zeros((B, HQ, t))
    for b in range(B):
        keys = np.concatenate([k[p] for p in pb["table"][b]], axis=1)
        for h in range(HQ):
            for i in range(t):
                logit = keys[h // g] @ pb["q"][b, i, h] * D**-0.5
                lv = logit[: start[b] + i + 1]
                out[b, h, i] = np.log(np.exp(lv - lv.max()).sum()) + lv.max()
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_plain_lse_and_gathered_cache(quant):
    """``flash_decode_paged_plain`` is the contiguous plain version on the
    gathered cache: its lse against an independent numpy reference, its
    output against ``flash_decode_plain`` on the cache gathered by hand."""
    start = np.asarray([4, 23, 11], np.int32)
    pb = _problem(3, ps=4, n_pages=6, t=2, quant=quant)
    opt = (lambda x: None if x is None else _t(x))
    o, lse = tdec.flash_decode_paged_plain(
        _t(pb["q"]), _t(pb["k"]), _t(pb["v"]), start=_t(start),
        page_table=_t(pb["table"]), k_scale=opt(pb["ks"]),
        v_scale=opt(pb["vs"]),
    )
    assert lse.shape == (B, HQ, 2) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _ref_lse(pb, start, 2, 4),
                               rtol=1e-5, atol=2e-5)

    def gathered(pool, scale):
        x = pool.astype(np.float32)
        if scale is not None:
            x = x * scale[..., None]
        return np.stack([np.concatenate([x[p] for p in row], axis=1)
                         for row in pb["table"]])

    o_dense, _ = tdec.flash_decode_plain(
        _t(pb["q"]), _t(gathered(pb["k"], pb["ks"])),
        _t(gathered(pb["v"], pb["vs"])), start=_t(start))
    np.testing.assert_array_equal(o.numpy(), o_dense.numpy())


def test_quantize_rows_is_bitwise_the_reference():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((5, 3, 16)) * rng.uniform(0, 4, (5, 3, 1))
         ).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero vector quantizes to zeros with scale 0
    want_q, want_s = jax_quantize_rows(jnp.asarray(x))
    got_q, got_s = _quantize_rows(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_q[1, 2] == 0).all() and float(got_s[1, 2]) == 0.0


def test_paged_decode_bytes_counts_visible_pages():
    # rows at slots 0 and 10 with page 4: 1 and 3 pages visible
    base = dict(t=1, b=2, hq=4, hkv=2, d=16, itemsize=2)
    got = tdec.flash_decode_bytes(torch.tensor([0, 10]), **base,
                                  page_size=4, n_pages=6)
    qo = 2 * 2 * 1 * 4 * 16 * 2
    assert got == (1 + 3) * 4 * 2 * 2 * 16 * 2 + qo + 4 * 2 * 6
    got8 = tdec.flash_decode_bytes(torch.tensor([0, 10]), **base,
                                   page_size=4, n_pages=6, kv_itemsize=1,
                                   quant=True)
    assert got8 == (1 + 3) * 4 * 2 * 2 * (16 + 4) + qo + 4 * 2 * 6
    # a window of 3 at slot 10 sees slots 8..10: one page
    gotw = tdec.flash_decode_bytes(torch.tensor([10, 10]), **base,
                                   window_size=3, page_size=4, n_pages=6)
    assert gotw == 2 * 4 * 2 * 2 * 16 * 2 + qo + 4 * 2 * 6


def test_paged_wrapper_raises_for_a_non_cpu_non_cuda_tensor():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    pool = torch.zeros(3, 2, 8, 64, device="meta")
    table = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    before = (tdec.flash_decode_paged.plain_calls,
              tdec.flash_decode_paged.launches)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tdec.flash_decode_attention(q, pool, pool, start=torch.zeros(1),
                                    page_table=table)
    assert (tdec.flash_decode_paged.plain_calls,
            tdec.flash_decode_paged.launches) == before


# -- module level -----------------------------------------------------------

E, DM, DML, PS = 32, 8, 16, 4


def _cos_sin(positions):
    inv, scale = compute_rope_frequencies(DM, 10_000.0)
    cos, sin = make_rope_cos_sin(jnp.asarray(positions), inv, scale)
    return np.asarray(cos), np.asarray(sin)


@pytest.fixture(scope="module")
def gqa_pair():
    """(jax module, params, jitted step, port module) sharing weights; the
    JAX step is jitted once."""
    from flax.core import meta as flax_meta
    from flax.traverse_util import flatten_dict

    kw = dict(qk_norm=True, use_sinks=True, window_size=6)
    jmod = JaxGQA(hidden_size=E, num_heads=4, num_kv_heads=2, head_dim=DM,
                  sdpa=jax_eager, decode_max_length=DML, dtype=jnp.float32,
                  **kw)
    x0 = jnp.zeros((2, 3, E), jnp.float32)
    cos0, sin0 = _cos_sin(np.zeros((2, 3), np.int32))
    params = flax_meta.unbox(jax.jit(jmod.clone(decode_max_length=0).init)(
        jax.random.PRNGKey(0), x0, cos0, sin0)["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    tmod = GroupedQueryAttention(
        E, 4, 2, DM, build_sdpa_backend(SdpaEagerConfig()),
        decode_max_length=DML, dtype=torch.float32, device="cpu", **kw)
    load_jax_params(tmod, {k: np.asarray(v) for k, v in
                           flatten_dict(params, sep="/").items()})
    step = jax.jit(lambda c, x, cos, sin: jmod.apply(
        {"params": params, "cache": c}, x, cos, sin, mutable=["cache"]))
    return step, tmod


def _tables():
    # row 1's pages in descending order; row 0 reuses page 9 (pool has 10)
    return np.asarray([[3, 9, 1, 5], [8, 6, 4, 2]], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_gqa_paged_cache_matches_jax_module(quant, gqa_pair, monkeypatch):
    """Six single-token steps with per-row write indices, one row re-admitted
    half-way: outputs and pools match the JAX module's (see the module
    docstring for the int8 rule)."""
    monkeypatch.setenv("D9D_TPU_DECODE_ATTN", "eager")
    step, tmod = gqa_pair
    n_pool = 10
    cache = PagedDecodeCache(1, 2, 2, DML, DM, page_size=PS,
                             num_pages=n_pool, dtype=torch.float32,
                             kv_quant="int8" if quant else None,
                             device="cpu")
    table = _tables()
    cache.page_table.copy_(_t(table))
    pool_dt = jnp.int8 if quant else jnp.float32
    jc = {"cached_key": jnp.zeros((n_pool, 2, PS, DM), pool_dt),
          "cached_value": jnp.zeros((n_pool, 2, PS, DM), pool_dt),
          "cache_index": jnp.zeros((2,), jnp.int32),
          "page_table": jnp.asarray(table)}
    if quant:
        for leaf in ("cached_key", "cached_value"):
            jc[leaf + PAGED_SCALE_SUFFIX] = jnp.zeros((n_pool, 2, PS),
                                                      jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, E)).astype(np.float32)
    row_pos = np.asarray([5, 0], np.int32)
    cache.index.copy_(_t(row_pos))
    jc["cache_index"] = jnp.asarray(row_pos)
    for i in range(6):
        if i == 3:  # re-admit row 1 at slot 0
            row_pos[1] = 0
            cache.index[1] = 0
            jc["cache_index"] = jc["cache_index"].at[1].set(0)
        cos, sin = _cos_sin(row_pos[:, None])
        want, st = step(jc, jnp.asarray(x[:, i:i + 1]), cos, sin)
        jc = st["cache"]
        got = tmod(_t(x[:, i:i + 1]), _t(cos), _t(sin), None,
                   cache.layer(0, 1))
        cache.advance(1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        row_pos += 1
    for leaf, pools in cache.pools.items():
        got, want = pools[0].detach().numpy(), np.asarray(jc[leaf])
        if got.dtype == np.int8:
            # the k/v projections differ in float rounding, so a value at a
            # rounding boundary may land one quantization step away
            assert np.abs(got.astype(np.int32) - want).max() <= 1, leaf
            assert (got != want).mean() < 0.01, leaf
        else:
            np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(cache.index.numpy(),
                                  np.asarray(jc["cache_index"]))


def test_gqa_paged_contracts_fail_loudly(gqa_pair):
    _, tmod = gqa_pair
    cache = PagedDecodeCache(1, 2, 2, DML, DM, page_size=PS, num_pages=10,
                             dtype=torch.float32, device="cpu")
    x3 = torch.zeros(2, 3, E)
    cos, sin = map(_t, _cos_sin(np.zeros((2, 3), np.int32)))
    with pytest.raises(NotImplementedError, match="single-token"):
        tmod(x3, cos, sin, None, cache.layer(0, 3))
    with pytest.raises(NotImplementedError, match="slot mask"):
        tmod(x3[:, :1], cos[:, :1], sin[:, :1],
             torch.ones(2, 1, 1, DML, dtype=torch.bool), cache.layer(0, 1))
    with pytest.raises(ValueError, match="kv_quant"):
        PagedDecodeCache(1, 2, 2, DML, DM, page_size=PS, num_pages=10,
                         dtype=torch.float32, kv_quant="int4", device="cpu")
