"""The serving slice of the PyTorch port as a whole vs the JAX package:
``generate`` and ``ContinuousBatcher`` on the CPU, float32, flax weights
carried across by ``load_jax_params``, prompts from numpy.

Greedy token streams must be IDENTICAL to the JAX package's. Sampling
draws differ between the two random generators by construction, so for
temperature / top-k / top-p the filtered logits are compared instead.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

from d9d_tpu.loop.serve import ContinuousBatcher as JaxBatcher
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JaxLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JaxConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as jax_eager
from d9d_tpu_torch.loop import ContinuousBatcher, generate
from d9d_tpu_torch.loop.generate import (
    _nucleus_filter,
    _top_k_filter,
    sample_tokens,
)
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.decode_flags import in_continuation_chunk

torch.set_num_threads(1)

# the package re-exports the function under the module's name
jgen = importlib.import_module("d9d_tpu.loop.generate")

VOCAB, DML = 64, 24
_KW = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=8, intermediate_size=64)


@pytest.fixture(scope="module")
def pair():
    """(jax decode model, flax params, torch decode model) sharing weights;
    the JAX generate is jitted once per static signature."""
    jm = JaxLM(config=JaxConfig(remat=False, **_KW), sdpa=jax_eager,
               dtype=jnp.float32, decode_max_length=DML)
    full = JaxLM(config=JaxConfig(remat=False, **_KW), sdpa=jax_eager,
                 dtype=jnp.float32)
    z = jnp.zeros((2, 4), jnp.int32)
    params = flax_meta.unbox(
        jax.jit(full.init)(jax.random.PRNGKey(0), z, z, z)["params"])
    tm = Qwen3DenseCausalLM(Qwen3DenseConfig(**_KW), decode_max_length=DML,
                            dtype=torch.float32, device="cpu")
    load_jax_params(
        tm, {k: np.asarray(v)
             for k, v in flatten_dict(params, sep="/").items()})
    return jm, params, tm


def _jax_generate(jm, params, ids, **kw):
    lengths = kw.pop("prompt_lengths", None)
    fn = jax.jit(lambda p, i, l: jgen.generate(
        jm, p, i, prompt_lengths=l, **kw))
    return np.asarray(fn(params, jnp.asarray(ids, jnp.int32),
                         None if lengths is None
                         else jnp.asarray(lengths, jnp.int32)))


def _prompts(seed, count, lo=2, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(count)]


_GEN_CASES = {
    "dense_batch": dict(),
    "ragged": dict(lengths=[9, 4, 6]),
    "ragged_chunked_prefill": dict(lengths=[9, 4, 6], prefill_chunk_size=4),
    "chunked_prefill": dict(prefill_chunk_size=3),
    "single_new_token": dict(max_new_tokens=1),
}


@pytest.mark.parametrize("case", list(_GEN_CASES))
def test_generate_greedy_tokens_identical_to_jax(case, pair):
    jm, params, tm = pair
    spec = dict(_GEN_CASES[case])
    n = spec.pop("max_new_tokens", 7)
    lengths = spec.pop("lengths", None)
    ids = np.random.default_rng(0).integers(0, VOCAB, (3, 9)).astype(np.int32)
    want = _jax_generate(jm, params, ids, max_new_tokens=n,
                         prompt_lengths=lengths, **spec)
    got = generate(
        tm, torch.from_numpy(ids), max_new_tokens=n,
        prompt_lengths=None if lengths is None else torch.tensor(lengths),
        **spec,
    )
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not in_continuation_chunk()  # the flag is always reset


def test_generate_eos_freezes_rows_like_jax(pair):
    jm, params, tm = pair
    ids = np.random.default_rng(1).integers(0, VOCAB, (3, 6)).astype(np.int32)
    free = _jax_generate(jm, params, ids, max_new_tokens=8)
    eos = int(free[0, 2])  # a token row 0 really emits mid-stream
    want = _jax_generate(jm, params, ids, max_new_tokens=8, eos_id=eos)
    got = generate(tm, torch.from_numpy(ids), max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 2:] == eos).all()


def test_ragged_rows_match_their_unpadded_generation(pair):
    _, _, tm = pair
    ids = np.random.default_rng(2).integers(0, VOCAB, (3, 9))
    lengths = [9, 4, 6]
    batch = generate(tm, torch.from_numpy(ids), max_new_tokens=6,
                     prompt_lengths=torch.tensor(lengths))
    for i, n in enumerate(lengths):
        alone = generate(tm, torch.from_numpy(ids[i:i + 1, 9 - n:]),
                         max_new_tokens=6)
        np.testing.assert_array_equal(batch[i:i + 1].numpy(), alone.numpy())


@pytest.mark.parametrize("top_k", [1, 5, 63])
def test_top_k_filter_equals_jax(top_k):
    logits = np.random.default_rng(3).standard_normal((4, VOCAB)).astype(
        np.float32)
    want = np.asarray(jgen._top_k_filter(jnp.asarray(logits), top_k))
    got = _top_k_filter(torch.from_numpy(logits), top_k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_nucleus_filter_equals_jax(top_p):
    logits = 3 * np.random.default_rng(4).standard_normal((4, VOCAB)).astype(
        np.float32)
    want = np.asarray(jgen._nucleus_filter(jnp.asarray(logits), top_p))
    got = _nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)


def test_sampling_draws_stay_inside_the_filtered_set(pair):
    _, _, tm = pair
    logits = torch.from_numpy(
        3 * np.random.default_rng(5).standard_normal((64, VOCAB)).astype(
            np.float32))
    gen = torch.Generator().manual_seed(0)
    allowed = torch.isfinite(_nucleus_filter(
        _top_k_filter(logits / 0.7, 8), 0.8))
    for _ in range(5):
        tok = sample_tokens(logits, temperature=0.7, top_k=8, top_p=0.8,
                            generator=gen)
        assert tok.dtype == torch.int32
        assert allowed[torch.arange(64), tok.long()].all()
    ids = torch.from_numpy(
        np.random.default_rng(6).integers(0, VOCAB, (2, 5)))
    a = generate(tm, ids, max_new_tokens=5, temperature=0.9, top_k=10,
                 generator=torch.Generator().manual_seed(7))
    b = generate(tm, ids, max_new_tokens=5, temperature=0.9, top_k=10,
                 generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_generate_argument_validation(pair):
    _, _, tm = pair
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        generate(tm, ids, max_new_tokens=2, temperature=1.0)
    with pytest.raises(ValueError, match="top_p must be"):
        generate(tm, ids, max_new_tokens=2, temperature=1.0, top_p=1.5,
                 generator=torch.Generator())
    with pytest.raises(ValueError, match="top_k must be"):
        generate(tm, ids, max_new_tokens=2, temperature=1.0, top_k=0,
                 generator=torch.Generator())
    with pytest.raises(ValueError, match="no effect"):
        generate(tm, ids, max_new_tokens=2, top_k=3)
    with pytest.raises(ValueError, match="decode_max_length"):
        generate(tm, ids, max_new_tokens=DML)
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        generate(tm, ids, max_new_tokens=2, prefill_chunk_size=0)


# -- ContinuousBatcher ------------------------------------------------------

def _oracle(tm, prompt, n, eos=None):
    out = generate(tm, torch.tensor([prompt]), max_new_tokens=n,
                   eos_id=eos).tolist()[0]
    if eos is not None and eos in out:
        out = out[: out.index(eos) + 1]
    return out


def _run_torch(tm, prompts, budgets, *, chunk, eos=None, batch_size=2,
               overlap=True):
    b = ContinuousBatcher(tm, batch_size=batch_size, chunk_size=chunk,
                          eos_id=eos, overlap=overlap)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    out = b.drain()
    return [out[r] for r in rids], b


@pytest.fixture(scope="module")
def jax_streams(pair):
    """Per-request streams of the JAX batcher (more requests than slots),
    computed once per (chunk, eos)."""
    jm, params, _ = pair
    cache = {}

    def run(prompts, budgets, chunk, eos=None):
        key = (chunk, eos)
        if key not in cache:
            b = JaxBatcher(jm, params, batch_size=2, chunk_size=chunk,
                           eos_id=eos)
            rids = [b.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, budgets)]
            out = b.drain()
            cache[key] = [list(out[r]) for r in rids]
        return cache[key]

    return run


@pytest.mark.parametrize("chunk", [None, 4])
def test_batcher_streams_identical_to_jax_batcher_and_generate(
        chunk, pair, jax_streams):
    _, _, tm = pair
    prompts = _prompts(0, 5)
    budgets = [6, 3, 8, 5, 7]
    got, b = _run_torch(tm, prompts, budgets, chunk=chunk)
    want = jax_streams(prompts, budgets, chunk)
    assert got == want
    for p, n, g in zip(prompts, budgets, got):
        assert g == _oracle(tm, p, n)
        assert len(g) == n
    assert b.active == 0 and len(b.done) == 5


@pytest.mark.parametrize("chunk", [None, 4])
def test_batcher_eos_matches_jax_batcher(chunk, pair, jax_streams):
    _, _, tm = pair
    prompts = _prompts(1, 5)
    budgets = [8] * 5
    free = _oracle(tm, prompts[0], 8)
    eos = free[3]
    got, _ = _run_torch(tm, prompts, budgets, chunk=chunk, eos=eos)
    want = jax_streams(prompts, budgets, chunk, eos)
    assert got == want
    for p, g in zip(prompts, got):
        assert g == _oracle(tm, p, 8, eos)
    assert got[0][-1] == eos and len(got[0]) <= 4


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_fused_chunks_match_per_token_path(chunk, pair):
    _, _, tm = pair
    prompts = _prompts(2, 6)
    budgets = [5, 9, 2, 7, 4, 6]
    want, _ = _run_torch(tm, prompts, budgets, chunk=None, batch_size=3)
    got, _ = _run_torch(tm, prompts, budgets, chunk=chunk, batch_size=3)
    assert got == want
    got_sync, _ = _run_torch(tm, prompts, budgets, chunk=chunk, batch_size=3,
                             overlap=False)
    assert got_sync == want


def test_fused_dispatch_and_readback_counters(pair):
    """One dispatch and ONE readback per K-step chunk."""
    _, _, tm = pair
    prompts = _prompts(3, 2, lo=3, hi=4)
    _, b = _run_torch(tm, prompts, [8, 8], chunk=4)
    s = b.stats
    assert s.chunks == s.host_dispatches == s.readbacks
    assert s.device_steps == 4 * s.chunks
    assert s.emitted_tokens == 16
    assert s.readbacks_per_1k_tokens == pytest.approx(
        1000 * s.readbacks / 16)
    assert 0 < s.slot_utilization <= 1
    _, legacy = _run_torch(tm, prompts, [8, 8], chunk=None)
    assert legacy.stats.readbacks == legacy.stats.device_steps
    assert legacy.stats.readbacks > s.readbacks


@pytest.mark.parametrize("chunk", [None, 4])
def test_idle_slot_write_index_stays_pinned(chunk, pair):
    _, _, tm = pair
    b = ContinuousBatcher(tm, batch_size=3, chunk_size=chunk)
    b.submit([1, 2, 3], max_new_tokens=12)
    b.drain()
    # rows 1, 2 idled for every step (pinned); row 0 finished (pinned in the
    # fused path the step it died, zeroed at eviction in the per-token path)
    assert b._cache.index.tolist() == [0, 0, 0]


def test_step_and_step_chunk_api(pair):
    _, _, tm = pair
    b = ContinuousBatcher(tm, batch_size=2, chunk_size=4)
    assert b.step() == {} and b.step_chunk() == {}
    prompt = [5, 6, 7]
    rid = b.submit(prompt, max_new_tokens=6)
    want = _oracle(tm, prompt, 6)
    out = b.step_chunk()  # 3 prompt steps consumed, 2 tokens emitted
    assert out == {rid: want[:2]}
    assert b.step() == {rid: want[2]}
    b.drain()
    assert b.outputs[rid] == want
    legacy = ContinuousBatcher(tm, batch_size=2, chunk_size=None)
    with pytest.raises(RuntimeError, match="fused batcher"):
        legacy.step_chunk()
    rid = legacy.submit(prompt, max_new_tokens=2)
    seen = []
    while legacy.active:
        seen += list(legacy.step().values())
    assert seen == want[:2]


def test_batcher_validation_and_unported_modes(pair):
    _, _, tm = pair
    b = ContinuousBatcher(tm, batch_size=2)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="exceeds decode_max_length"):
        b.submit([1] * 20, max_new_tokens=10)
    with pytest.raises(ValueError, match="chunk_size"):
        ContinuousBatcher(tm, batch_size=2, chunk_size=0)
    with pytest.raises(ValueError, match="Generator"):
        ContinuousBatcher(tm, batch_size=2, temperature=0.5)
    # the paged-mode argument checks of the JAX batcher (serve.py:531-551)
    with pytest.raises(ValueError, match="page_size must be >= 1"):
        ContinuousBatcher(tm, batch_size=2, page_size=0)
    with pytest.raises(ValueError, match="need paged mode"):
        ContinuousBatcher(tm, batch_size=2, num_pages=8)
    with pytest.raises(ValueError, match="need paged mode"):
        ContinuousBatcher(tm, batch_size=2, prefix_cache=False)
    with pytest.raises(ValueError, match="kv_quant needs paged mode"):
        ContinuousBatcher(tm, batch_size=2, kv_quant="int8")
    with pytest.raises(ValueError, match="kv_quant must be None or 'int8'"):
        ContinuousBatcher(tm, batch_size=2, page_size=8, kv_quant="fp8")
    # still to port (ROADMAP A10)
    paged = ContinuousBatcher(tm, batch_size=2, page_size=8)
    with pytest.raises(NotImplementedError, match="export_kv_pages"):
        paged.export_kv_pages(0)
    with pytest.raises(NotImplementedError, match="import_kv_pages"):
        paged.import_kv_pages(None)
    sampled = ContinuousBatcher(tm, batch_size=2, temperature=0.8,
                                generator=torch.Generator().manual_seed(0))
    rid = sampled.submit([3, 4], max_new_tokens=5)
    assert len(sampled.drain()[rid]) == 5
