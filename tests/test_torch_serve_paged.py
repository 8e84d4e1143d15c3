"""The paged serving slice of the PyTorch port vs the JAX package on the
CPU: ``ContinuousBatcher(page_size=..., prefix_cache=..., kv_quant=...)`` of
both on the tiny float32 Qwen3 model of ``tests/loop/test_serve_paged.py``
(weights carried across by ``load_jax_params``), and the port's copy of the
page allocator run through the cases of ``tests/loop/test_kv_paging.py``.

Greedy token streams must be IDENTICAL to the JAX paged batcher's — in
float32 pools and in int8 pools (both sides dequantize ``int8 * scale`` in
float32) — and, in float32, to the port's own contiguous batcher and
``generate``. The JAX batchers run once each (module-scoped fixture) with
their eager paged read, as the reference's own serving tests do on the CPU.
"""
import inspect

import numpy as np
import pytest
import torch

from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

import tests.loop.test_kv_paging as kv_cases
from tests.loop.test_serve import VOCAB, _dense, _params, _prompts

from d9d_tpu.loop.serve import ContinuousBatcher as JaxBatcher
from d9d_tpu_torch.loop import ContinuousBatcher, generate
from d9d_tpu_torch.loop.kv_paging import PagedKVAllocator
from d9d_tpu_torch.loop.serve import _Slot
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig

PAGE, DML = 8, 24  # 3 pages per row
_KW = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=8, intermediate_size=64)


@pytest.fixture(scope="module")
def models():
    """(jax model, flax params, torch model) sharing weights."""
    jm = _dense(DML)
    params = flax_meta.unbox(_params(jm))
    tm = Qwen3DenseCausalLM(Qwen3DenseConfig(**_KW), decode_max_length=DML,
                            dtype=torch.float32, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         flatten_dict(params, sep="/").items()})
    return jm, params, tm


def _staggered(make, prompts, n, chunk):
    """The reference's staggered schedule: one request, one boundary, the
    rest (admissions between chunk boundaries, budgets ending mid-chunk)."""
    b = make()
    rids = [b.submit(prompts[0], max_new_tokens=n)]
    if chunk is None:
        b.step()
    else:
        b.step_chunk()
    rids += [b.submit(p, max_new_tokens=n) for p in prompts[1:]]
    out = b.drain()
    return [list(out[r]) for r in rids], b


def _prefix_sequence(make, prompt):
    """A cold serving, a prefix hit, then two hits decoding together."""
    b = make()
    r1 = b.submit(prompt, max_new_tokens=5)
    cold = list(b.drain()[r1])
    r2 = b.submit(prompt, max_new_tokens=5)
    hit = list(b.drain()[r2])
    r3 = b.submit(prompt, max_new_tokens=5)
    r4 = b.submit(prompt, max_new_tokens=5)
    out = b.drain()
    return [cold, hit, list(out[r3]), list(out[r4])], b


STAGGERED = _prompts(10, 4)
SHARED = _prompts(42, 1, lo=18, hi=19)[0]  # 2 full pages + a tail of 2


@pytest.fixture(scope="module")
def jax_runs(models):
    """Streams and prefix counters of the JAX paged batcher, fp32 and int8,
    each schedule run once."""
    jm, params, _ = models
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("D9D_TPU_DECODE_ATTN", "eager")
        for quant in (None, "int8"):
            def make(**kw):
                return JaxBatcher(jm, params, batch_size=2, chunk_size=4,
                                  page_size=PAGE, kv_quant=quant, **kw)

            out["staggered", quant], _ = _staggered(make, STAGGERED, 6, 4)
            streams, b = _prefix_sequence(
                lambda: make(num_pages=9), SHARED)
            out["prefix", quant] = (streams, b._kv.prefix_hits,
                                    b._kv.prefix_misses,
                                    b._kv.prefix_hit_tokens)
    return out


def _port(tm, chunk=4, **kw):
    return lambda: ContinuousBatcher(tm, batch_size=2, chunk_size=chunk,
                                     **kw)


def _oracle(tm, prompt, n):
    return generate(tm, torch.tensor([prompt]), max_new_tokens=n)[0].tolist()


@pytest.mark.parametrize("chunk", [None, 1, 4, 16])
def test_paged_streams_identical_to_jax_and_contiguous(chunk, models,
                                                       jax_runs):
    _, _, tm = models
    want = jax_runs["staggered", None]
    got, b = _staggered(_port(tm, chunk, page_size=PAGE), STAGGERED, 6, chunk)
    assert got == want
    contiguous, _ = _staggered(_port(tm, chunk), STAGGERED, 6, chunk)
    assert contiguous == want
    for out, prompt in zip(got, STAGGERED):
        assert out == _oracle(tm, prompt, 6)
    b._kv.check_invariants()
    # only the cached prefix pages stay mapped after the drain
    assert b._kv.pages_in_use == len(b._kv._entries)
    assert b._cache.index.tolist() == [0, 0]
    if chunk is not None:  # rows that died on the device name page 0
        assert b._cache.page_table.tolist() == [[0] * 3, [0] * 3]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_prefix_hit_streams_and_counters_identical_to_jax(quant, models,
                                                          jax_runs):
    """A shared prompt's second serving hits the prefix cache (its two
    full pages are skipped) and decodes exactly like the cold one, in both
    pool types; streams and hit counters equal the JAX batcher's."""
    _, _, tm = models
    want, hits, misses, hit_tokens = jax_runs["prefix", quant]
    got, b = _prefix_sequence(
        _port(tm, page_size=PAGE, num_pages=9, kv_quant=quant), SHARED)
    assert got == want
    assert got[1:] == [got[0]] * 3
    if quant is None:
        assert got[0] == _oracle(tm, SHARED, 5)
    assert (b._kv.prefix_hits, b._kv.prefix_misses,
            b._kv.prefix_hit_tokens) == (hits, misses, hit_tokens)
    assert (hits, hit_tokens) == (3, 3 * 2 * PAGE)
    assert b.prefix_hit_rate() == 0.75
    b._kv.check_invariants()


def test_int8_streams_identical_to_jax(models, jax_runs):
    _, _, tm = models
    got, b = _staggered(_port(tm, page_size=PAGE, kv_quant="int8"),
                        STAGGERED, 6, 4)
    assert got == jax_runs["staggered", "int8"]
    pools = b._cache.pools
    assert set(pools) == {"cached_key", "cached_value", "cached_key_scale",
                          "cached_value_scale"}
    assert pools["cached_key"][0].dtype == torch.int8
    assert pools["cached_key_scale"][0].dtype == torch.float32
    assert float(pools["cached_key_scale"][0].abs().max()) > 0.0


def test_paged_admission_bounded_by_free_pages(models):
    """A pool smaller than the slots' worst case: the queue head waits for
    pages (never rejected, nothing corrupted) and both decode exactly."""
    _, _, tm = models
    prompts = _prompts(12, 2, lo=4, hi=6)
    # each request needs 2 pages; the pool holds 2 allocatable
    b = ContinuousBatcher(tm, batch_size=2, chunk_size=4, page_size=PAGE,
                          num_pages=3, prefix_cache=False)
    r1 = b.submit(prompts[0], max_new_tokens=8)
    r2 = b.submit(prompts[1], max_new_tokens=8)
    b.step_chunk()
    assert sum(1 for s in b._slots if s.rid >= 0) == 1
    assert b._kv.pages_free == 0 and b.active == 2
    out = b.drain()
    assert out[r1] == _oracle(tm, prompts[0], 8)
    assert out[r2] == _oracle(tm, prompts[1], 8)
    b._kv.check_invariants()
    with pytest.raises(ValueError, match="could never be admitted"):
        b.submit(list(range(10)), max_new_tokens=12)


def test_deferred_release_holds_pages_until_the_next_clean_boundary(models):
    """A row the host retires while its chunk is in flight keeps its pages
    (its device twin may still write them) until the next admission
    boundary pushes its zeroed table row; the request admitted there
    decodes exactly."""
    _, _, tm = models
    prompts = _prompts(13, 2, lo=3, hi=5)
    b = ContinuousBatcher(tm, batch_size=1, chunk_size=4, page_size=PAGE,
                          prefix_cache=False)
    b.submit(prompts[0], max_new_tokens=18)
    b._dispatch_chunk(4, admit=True)  # in flight, not harvested
    held = b._kv.pages_in_use
    assert held == 3
    b._slots[0] = _Slot()  # the host retires the request
    b._release_row_pages(0, device_dead=False)
    assert b._kv.pages_in_use == held and b._kv._deferred
    b._kv.check_invariants()
    b._sync()
    fresh = b.submit(prompts[1], max_new_tokens=6)
    out = b.drain()
    assert not b._kv._deferred
    assert out[fresh] == _oracle(tm, prompts[1], 6)
    b._kv.check_invariants()


def test_paged_counts_dispatches_like_contiguous_and_holds_fewer_bytes(
        models):
    """Paging adds no dispatch and no readback to the same schedule, and the
    KV bytes resident per request fall: pages mapped vs every row's full
    decode_max_length; int8 pools less again."""
    _, _, tm = models
    prompts = _prompts(15, 3)
    runs = {}
    for name, kw in (("contiguous", {}),
                     ("paged", dict(page_size=PAGE, prefix_cache=False)),
                     ("int8", dict(page_size=PAGE, prefix_cache=False,
                                   kv_quant="int8"))):
        b = ContinuousBatcher(tm, batch_size=2, chunk_size=4, **kw)
        for p in prompts:
            b.submit(p, max_new_tokens=6)
        b.drain()
        runs[name] = b
    contig, paged, int8 = runs["contiguous"], runs["paged"], runs["int8"]
    assert paged.outputs == contig.outputs
    for b in (paged, int8):
        assert b.stats.host_dispatches == contig.stats.host_dispatches
        assert b.stats.readbacks == contig.stats.readbacks
        assert b._kv.pages_in_use == 0
    assert contig.hbm_bytes_per_request() == 2 * 2 * 2 * 2 * DML * 8 * 4 / 2
    assert paged.hbm_bytes_per_request() < contig.hbm_bytes_per_request()
    assert int8.hbm_bytes_per_request() < paged.hbm_bytes_per_request()
    # one page over both layers' k and v pools (and int8 scales)
    assert paged._page_bytes == 2 * 2 * 2 * PAGE * 8 * 4
    assert int8._page_bytes == 2 * 2 * 2 * PAGE * (8 + 4)


def test_prefix_cache_refused_for_unpageable_leaves(models, monkeypatch):
    """prefix_cache=True on a model whose cache holds per-row recurrent
    state (the reference's GDN layers) raises; left at None it turns off."""
    from d9d_tpu_torch.nn import PagedDecodeCache

    _, _, tm = models
    monkeypatch.setattr(PagedDecodeCache, "unpageable_leaves",
                        ("delta_state",))
    with pytest.raises(ValueError, match="unsound"):
        ContinuousBatcher(tm, batch_size=2, page_size=PAGE,
                          prefix_cache=True)
    b = ContinuousBatcher(tm, batch_size=2, page_size=PAGE)
    assert b._kv.prefix_cache_enabled is False


_ALLOCATOR_CASES = [
    fn for name, fn in inspect.getmembers(kv_cases, inspect.isfunction)
    if name.startswith("test_")
]


@pytest.mark.parametrize("case", _ALLOCATOR_CASES,
                         ids=lambda fn: fn.__name__[len("test_"):])
def test_port_allocator_passes_the_reference_cases(case, monkeypatch):
    """Every case of the reference's allocator tests, run on the port's
    copy of ``PagedKVAllocator``."""
    monkeypatch.setattr(kv_cases, "PagedKVAllocator", PagedKVAllocator)
    case()
