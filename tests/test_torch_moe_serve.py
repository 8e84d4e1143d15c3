"""Serving the Qwen3-MoE model of the PyTorch port vs the JAX package on the
CPU: ``generate`` (ragged prompts, chunked prefill) and ``ContinuousBatcher``
(contiguous, paged with prefix hits, int8 pools) on a narrow float32
``Qwen3MoeCausalLM`` — the widths of ``tests/loop/test_serve.py``'s MoE
model without its GDN layer — with the flax weights carried across by
``load_jax_params``.

Greedy token streams must be IDENTICAL to the JAX package's, for each
``moe_ffn`` variant of the port; on the CPU every variant runs its kernel's
plain version, and the tests count those calls. The JAX runs happen once
each (module-scoped fixtures), with the eager decode read the reference's
own serving tests use on the CPU. The JAX batcher runs with paged pools
only: its contiguous streams are its fp32 paged streams on every schedule
(``tests/loop/test_serve_paged.py``), so the port's contiguous batcher is
held to those, and its fp32 paged batcher to them and to its own
contiguous run.
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
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as jax_eager
from d9d_tpu_torch.loop import ContinuousBatcher, generate
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.ops import moe_ffn as mf

torch.set_num_threads(1)

# the package re-exports the function under the module's name
jgen = importlib.import_module("d9d_tpu.loop.generate")

VOCAB, DML, PAGE = 64, 24, 8  # 3 pages per row
_KW = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=8, moe_intermediate_size=32,
           num_experts=4, num_experts_per_tok=2, remat=False)
VARIANTS = ("aligned", "gather", "gather_combine")
_WRAPPER = {"aligned": mf.moe_ffn_aligned, "gather": mf.moe_ffn_gather,
            "gather_combine": mf.moe_ffn_gather_combine}

IDS = np.random.default_rng(0).integers(0, VOCAB, (3, 9)).astype(np.int32)
LENGTHS = [9, 4, 6]
GEN_CASES = {"ragged_chunked_prefill": dict(prefill_chunk_size=4)}


def _prompts(seed, count, lo=2, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(count)]


PROMPTS = _prompts(0, 5)
BUDGETS = [6, 3, 8, 5, 7]
SHARED = _prompts(42, 1, lo=18, hi=19)[0]  # 2 full pages + a tail of 2


@pytest.fixture(scope="module")
def models():
    """(jax decode model, flax params, {moe_ffn: torch decode model}), all
    sharing one set of weights."""
    jm = JQwen3MoeCausalLM(config=JQwen3MoeConfig(**_KW), sdpa=jax_eager,
                           dtype=jnp.float32, decode_max_length=DML)
    z = jnp.zeros((2, 4), jnp.int32)
    params = flax_meta.unbox(jax.jit(jm.clone(decode_max_length=0).init)(
        jax.random.PRNGKey(0), z, z, z)["params"])
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params, sep="/").items()}
    tms = {}
    for variant in VARIANTS:
        tm = Qwen3MoeCausalLM(Qwen3MoeConfig(**_KW), moe_ffn=variant,
                              decode_max_length=DML, dtype=torch.float32,
                              device="cpu", seed=None)
        load_jax_params(tm, flat)
        tms[variant] = tm
    return jm, params, tms


def _staggered(make, prompts, budgets):
    """One request, one chunk boundary, then the rest."""
    b = make()
    rids = [b.submit(prompts[0], max_new_tokens=budgets[0])]
    b.step_chunk()
    rids += [b.submit(p, max_new_tokens=n)
             for p, n in zip(prompts[1:], budgets[1:])]
    out = b.drain()
    return [list(out[r]) for r in rids], b


def _paged_sequence(make, prompt):
    """The staggered schedule, then on the same batcher a shared prompt
    served cold, with a prefix hit, then twice with hits decoding
    together: (staggered streams, prefix streams, batcher)."""
    staggered, b = _staggered(make, PROMPTS, BUDGETS)
    r1 = b.submit(prompt, max_new_tokens=5)
    cold = list(b.drain()[r1])
    r2 = b.submit(prompt, max_new_tokens=5)
    hit = list(b.drain()[r2])
    r3 = b.submit(prompt, max_new_tokens=5)
    r4 = b.submit(prompt, max_new_tokens=5)
    out = b.drain()
    return staggered, [cold, hit, list(out[r3]), list(out[r4])], b


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX package's greedy tokens: ``generate`` per case, and the
    paged batcher in fp32 and int8 pools (the paged sequence with its
    prefix hit counters)."""
    jm, params, _ = models
    out = {}
    for case, kw in GEN_CASES.items():
        fn = jax.jit(lambda p, i, l, kw=kw: jgen.generate(
            jm, p, i, prompt_lengths=l, max_new_tokens=6, **kw))
        out["generate", case] = np.asarray(
            fn(params, jnp.asarray(IDS), jnp.asarray(LENGTHS, jnp.int32)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("D9D_TPU_DECODE_ATTN", "eager")
        for quant in (None, "int8"):
            staggered, prefix, b = _paged_sequence(
                lambda quant=quant: JaxBatcher(
                    jm, params, batch_size=2, chunk_size=4, page_size=PAGE,
                    num_pages=9, kv_quant=quant), SHARED)
            out["paged", quant] = (staggered, prefix, b._kv.prefix_hits,
                                   b._kv.prefix_hit_tokens)
    return out


def _reset_plain_calls():
    for fn in _WRAPPER.values():
        fn.plain_calls = 0


def _assert_plain_calls(variant, moe_calls):
    """Only the variant's plain version ran, once per MoE layer call."""
    for name, fn in _WRAPPER.items():
        assert fn.plain_calls == (moe_calls if name == variant else 0), name


@pytest.mark.parametrize("case", list(GEN_CASES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_generate_greedy_tokens_identical_to_jax(variant, case, models,
                                                 jax_runs):
    _, _, tms = models
    _reset_plain_calls()
    got = generate(tms[variant], torch.from_numpy(IDS), max_new_tokens=6,
                   prompt_lengths=torch.tensor(LENGTHS), **GEN_CASES[case])
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), jax_runs["generate", case])
    # prefill chunks (9 tokens: 3 chunks of 4, or 1) + 5 decode steps, each
    # through both layers' MoE blocks
    chunks = -(-IDS.shape[1] // GEN_CASES[case].get("prefill_chunk_size",
                                                     IDS.shape[1]))
    _assert_plain_calls(variant, _KW["num_layers"] * (chunks + 5))


@pytest.mark.parametrize("variant", VARIANTS)
def test_batcher_streams_identical_to_jax_batcher(variant, models, jax_runs):
    _, _, tms = models
    _reset_plain_calls()
    got, b = _staggered(
        lambda: ContinuousBatcher(tms[variant], batch_size=2, chunk_size=4),
        PROMPTS, BUDGETS)
    assert got == jax_runs["paged", None][0]
    assert [len(g) for g in got] == BUDGETS
    _assert_plain_calls(variant, _KW["num_layers"] * b.stats.device_steps)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_streams_and_prefix_hits_identical_to_jax(variant, quant,
                                                         models, jax_runs):
    """Paged pools (fp32 and int8) on the staggered schedule, then a shared
    prompt served cold and with prefix hits: streams and hit counters equal
    the JAX paged batcher's; fp32 pools also equal the port's contiguous
    streams."""
    _, _, tms = models
    if quant is None:
        contiguous, _ = _staggered(
            lambda: ContinuousBatcher(tms[variant], batch_size=2,
                                      chunk_size=4), PROMPTS, BUDGETS)
    _reset_plain_calls()
    staggered, prefix, b = _paged_sequence(
        lambda: ContinuousBatcher(tms[variant], batch_size=2, chunk_size=4,
                                  page_size=PAGE, num_pages=9,
                                  kv_quant=quant), SHARED)
    want_staggered, want_prefix, hits, hit_tokens = jax_runs["paged", quant]
    assert staggered == want_staggered
    if quant is None:
        assert staggered == contiguous
    assert prefix == want_prefix
    assert b._kv.prefix_hits == hits >= 1
    assert b._kv.prefix_hit_tokens == hit_tokens
    b._kv.check_invariants()
    _assert_plain_calls(variant, _KW["num_layers"] * b.stats.device_steps)
