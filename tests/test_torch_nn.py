"""Blocks and the whole Qwen3-dense model of the PyTorch port vs the JAX
package on the CPU in float32, with the flax weights carried across by
``load_jax_params``.

The flax parameter tree is initialised by the JAX module, flattened HERE to
``{"a/b/kernel": np.ndarray}`` and loaded into the port's module. Inputs
come from numpy. Tolerances: rtol=1e-5, atol=1e-5 for single blocks, 1e-4
for whole-model logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JaxLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JaxConfig
from d9d_tpu.nn.attention import GroupedQueryAttention as JaxGQA
from d9d_tpu.nn.decode_flags import continuation_chunk as jax_continuation
from d9d_tpu.nn.decode_flags import in_continuation_chunk as jax_in_continuation
from d9d_tpu.nn.decoder import DecoderLayer as JaxLayer
from d9d_tpu.ops import compute_rope_frequencies, make_rope_cos_sin
from d9d_tpu.ops.attention.eager import eager_sdpa as jax_eager
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn import (
    DecodeCache,
    DecoderLayer,
    GroupedQueryAttention,
)
from d9d_tpu_torch.nn.decode_flags import continuation_chunk
from d9d_tpu_torch.nn.sdpa import (
    SdpaEagerConfig,
    SdpaFlashConfig,
    SdpaRingConfig,
    build_sdpa_backend,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
E, H, HKV, D, S_MAX = 32, 4, 2, 8, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _cos_sin(positions):
    inv, scale = compute_rope_frequencies(D, 10_000.0)
    cos, sin = make_rope_cos_sin(jnp.asarray(positions), inv, scale)
    return np.asarray(cos), np.asarray(sin)


_JITTED = {}


def _japply(mod, variables, *args, mutable=False, method=None):
    """``mod.apply`` under ``jax.jit`` (one compile per module, call kind and
    shape instead of one per primitive). The continuation flag is read while
    tracing, so it is part of the key and the call happens inside the
    caller's context."""
    key = (id(mod), mutable, method, jax_in_continuation())
    if key not in _JITTED:
        kw = {}
        if mutable:
            kw["mutable"] = ["cache"]
        if method is not None:
            kw["method"] = getattr(mod, method)
        # the module rides along so its id cannot be reused while cached
        _JITTED[key] = (mod, jax.jit(lambda v, *a: mod.apply(v, *a, **kw)))
    return _JITTED[key][1](variables, *args)


def _jinit(mod, seed, *args):
    return jax.jit(mod.init)(jax.random.PRNGKey(seed), *args)["params"]


def _randomize(params, seed):
    """flax inits norms to ones and sinks to zeros; perturb every leaf so a
    mis-mapped weight cannot hide."""
    rng = np.random.default_rng(seed)
    params = flax_meta.unbox(params)  # strip the logical-axis boxes
    return jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        params,
    )


_GQA_VARIANTS = {
    "qwen3": dict(qk_norm=True),
    "sinks_window_gate": dict(qk_norm=True, use_sinks=True, window_size=5,
                              use_output_gate=True),
    "fused_qkv_partial_rope": dict(fused_qkv=True, rope_fraction=0.5),
}


def _gqa_pair(variant, decode_max_length, sdpa="eager"):
    kw = _GQA_VARIANTS[variant]
    jmod = JaxGQA(hidden_size=E, num_heads=H, num_kv_heads=HKV, head_dim=D,
                  sdpa=jax_eager, decode_max_length=decode_max_length,
                  dtype=jnp.float32, **kw)
    x0 = jnp.zeros((2, 3, E), jnp.float32)
    cos0, sin0 = _cos_sin(np.zeros((2, 3), np.int32))
    params = _jinit(jmod, 0, x0, cos0, sin0)
    params = _randomize(params, 1)
    tmod = GroupedQueryAttention(
        E, H, HKV, D,
        build_sdpa_backend(SdpaEagerConfig() if sdpa == "eager"
                           else SdpaFlashConfig()),
        decode_max_length=decode_max_length, dtype=torch.float32,
        device="cpu", **kw,
    )
    load_jax_params(tmod, _flat(params))
    return jmod, params, tmod


@pytest.mark.parametrize("variant", list(_GQA_VARIANTS))
def test_gqa_training_path_matches_jax(variant):
    jmod, params, tmod = _gqa_pair(variant, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, E)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    cos, sin = _cos_sin(pos)
    want = _japply(jmod, {"params": params}, jnp.asarray(x), cos, sin)
    got = tmod(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _jax_decode_call(jmod, params, cache, x, pos):
    cos, sin = _cos_sin(pos)
    variables = {"params": params}
    if cache is not None:
        variables["cache"] = cache
    out, state = _japply(jmod, variables, jnp.asarray(x), cos, sin,
                         mutable=True)
    return np.asarray(out), state["cache"]


def _torch_decode_call(tmod, cache, x, pos):
    cos, sin = _cos_sin(pos)
    out = tmod(_t(x), _t(cos), _t(sin), None, cache.layer(0, x.shape[1]))
    cache.advance(x.shape[1])
    return out.detach().numpy()


@pytest.mark.parametrize(
    "variant,sdpa",
    [(v, "eager") for v in _GQA_VARIANTS] + [("sinks_window_gate", "flash")],
)
def test_gqa_decode_scalar_index_prefill_then_steps(variant, sdpa):
    """Prefill 5 tokens on the empty cache (fast path), a 3-token
    continuation chunk, then single-token steps — one shared write index."""
    jmod, params, tmod = _gqa_pair(variant, S_MAX, sdpa)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, E)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    cache = DecodeCache(1, 2, HKV, S_MAX, D, dtype=torch.float32, device="cpu")

    want, jcache = _jax_decode_call(jmod, params, None, x[:, :5], pos[:, :5])
    got = _torch_decode_call(tmod, cache, x[:, :5], pos[:, :5])
    np.testing.assert_allclose(got, want, **TOL)

    with jax_continuation():
        want, jcache = _jax_decode_call(jmod, params, jcache, x[:, 5:8],
                                        pos[:, 5:8])
    with continuation_chunk():
        got = _torch_decode_call(tmod, cache, x[:, 5:8], pos[:, 5:8])
    np.testing.assert_allclose(got, want, **TOL)

    for i in range(8, 11):
        want, jcache = _jax_decode_call(jmod, params, jcache, x[:, i:i + 1],
                                        pos[:, i:i + 1])
        got = _torch_decode_call(tmod, cache, x[:, i:i + 1], pos[:, i:i + 1])
        np.testing.assert_allclose(got, want, **TOL)
    assert int(cache.index) == int(jcache["cache_index"]) == 11
    np.testing.assert_allclose(
        cache.keys[0].detach().numpy(), np.asarray(jcache["cached_key"]), **TOL
    )


def test_gqa_decode_per_row_index_matches_jax(monkeypatch):
    """Per-row ``[B]`` write indices (continuous batching): rows advance
    independently, one is reset mid-way; single-token steps and a
    continuation chunk. The JAX side runs its Pallas decode kernel in
    interpret mode, as its own serving test does."""
    monkeypatch.setenv("D9D_TPU_DECODE_ATTN", "pallas")
    jmod, params, tmod = _gqa_pair("qwen3", S_MAX)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, E)).astype(np.float32)
    cache = DecodeCache(1, 2, HKV, S_MAX, D, dtype=torch.float32,
                        device="cpu", per_row=True)
    jcache = {
        "cached_key": jnp.zeros((2, HKV, S_MAX, D), jnp.float32),
        "cached_value": jnp.zeros((2, HKV, S_MAX, D), jnp.float32),
        "cache_index": jnp.zeros((2,), jnp.int32),
    }
    row_pos = np.zeros((2,), np.int32)
    for i in range(6):
        if i == 3:  # re-admit row 1: its index restarts at 0
            jcache["cache_index"] = jcache["cache_index"].at[1].set(0)
            cache.index[1] = 0
            row_pos[1] = 0
        pos = row_pos[:, None]
        want, jcache = _jax_decode_call(jmod, params, jcache, x[:, i:i + 1],
                                        pos)
        got = _torch_decode_call(tmod, cache, x[:, i:i + 1], pos)
        np.testing.assert_allclose(got, want, **TOL)
        row_pos += 1
    pos = row_pos[:, None] + np.arange(3, dtype=np.int32)[None, :]
    with jax_continuation():
        want, jcache = _jax_decode_call(jmod, params, jcache, x[:, 6:9], pos)
    with continuation_chunk():
        got = _torch_decode_call(tmod, cache, x[:, 6:9], pos)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(cache.index.numpy(),
                                  np.asarray(jcache["cache_index"]))


def test_gqa_decode_key_validity_mask_and_general_mask():
    """Left-padded prompts: a ``[B,1,1,S]`` key-validity mask becomes
    segments in the prefill and ``kv_valid`` in the steps; a head/query
    varying 4D mask takes the eager slot path on the CPU."""
    jmod, params, tmod = _gqa_pair("qwen3", S_MAX)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, E)).astype(np.float32)
    pad = np.array([0, 2])
    pos = np.maximum(np.arange(6)[None, :] - pad[:, None], 0).astype(np.int32)
    valid = (np.arange(S_MAX)[None, :] >= pad[:, None])[:, None, None, :]
    cache = DecodeCache(1, 2, HKV, S_MAX, D, dtype=torch.float32, device="cpu")

    def both(xs, ps, mask, jcache):
        cos, sin = _cos_sin(ps)
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        want, state = _japply(jmod, variables, jnp.asarray(xs), cos, sin,
                              jnp.asarray(mask), mutable=True)
        got = tmod(_t(xs), _t(cos), _t(sin), _t(mask),
                   cache.layer(0, xs.shape[1]))
        cache.advance(xs.shape[1])
        return got.detach().numpy(), np.asarray(want), state["cache"]

    got, want, jcache = both(x[:, :5], pos[:, :5], valid, None)
    # pad positions are don't-care but must stay finite
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1, 2:], want[1, 2:], **TOL)
    got, want, jcache = both(x[:, 5:6], pos[:, 5:6], valid, jcache)
    np.testing.assert_allclose(got, want, **TOL)
    general = np.broadcast_to(valid, (2, H, 1, S_MAX)).copy()
    general[0, 1, 0, 2] = False
    got, want, jcache = both(x[:, 5:6], pos[:, 5:6] + 1, general, jcache)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(NotImplementedError, match="4D"):
        tmod(_t(x[:, :1]), *map(_t, _cos_sin(pos[:, :1])),
             torch.ones(2, S_MAX, dtype=torch.bool), cache.layer(0, 1))


def test_decoder_layer_matches_jax():
    jmod = JaxLayer(hidden_size=E, num_heads=H, num_kv_heads=HKV, head_dim=D,
                    intermediate_size=48, sdpa=jax_eager, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, E)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    cos, sin = _cos_sin(pos)
    params = _randomize(_jinit(jmod, 1, jnp.asarray(x), cos, sin), 7)
    tmod = DecoderLayer(E, H, HKV, D, 48, build_sdpa_backend(),
                        dtype=torch.float32, device="cpu")
    load_jax_params(tmod, _flat(params))
    want = _japply(jmod, {"params": params}, jnp.asarray(x), cos, sin)
    got = tmod(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


VOCAB_RANGES = (("text", 48), ("special", 16))


def _model_pair(decode_max_length=0):
    kw = dict(vocab_ranges=VOCAB_RANGES, hidden_size=E, num_layers=2,
              num_heads=H, num_kv_heads=HKV, head_dim=D, intermediate_size=64)
    jm = JaxLM(config=JaxConfig(remat=False, **kw), sdpa=jax_eager,
               dtype=jnp.float32, decode_max_length=decode_max_length)
    z = jnp.zeros((2, 4), jnp.int32)
    full = JaxLM(config=JaxConfig(remat=False, **kw), sdpa=jax_eager,
                 dtype=jnp.float32)
    params = _randomize(_jinit(full, 0, z, z, z), 8)
    tm = Qwen3DenseCausalLM(Qwen3DenseConfig(**kw),
                            decode_max_length=decode_max_length,
                            dtype=torch.float32, device="cpu")
    load_jax_params(tm, _flat(params))
    return jm, params, tm


def test_model_logits_and_logits_last_match_jax():
    jm, params, tm = _model_pair()
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 64, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = _japply(jm, {"params": params}, jnp.asarray(ids), jnp.asarray(pos),
                   method="logits")
    got = tm.logits(_t(ids), _t(pos))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    want_last = _japply(jm, {"params": params}, jnp.asarray(ids),
                        jnp.asarray(pos), method="logits_last")
    got_last = tm.logits_last(_t(ids), _t(pos))
    assert got_last.shape == (2, 1, 64)
    np.testing.assert_allclose(got_last.detach().numpy(), np.asarray(want_last),
                               **MODEL_TOL)


def test_model_decode_mode_matches_jax_cache_path():
    jm, params, tm = _model_pair(decode_max_length=S_MAX)
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    cache = tm.init_cache(2)
    want, state = _japply(jm, {"params": params}, jnp.asarray(ids[:, :6]),
                          jnp.asarray(pos[:, :6]), method="logits",
                          mutable=True)
    got = tm.logits(_t(ids[:, :6]), _t(pos[:, :6]), cache=cache)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    for i in (6, 7):
        want, state = _japply(
            jm, {"params": params, "cache": state["cache"]},
            jnp.asarray(ids[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]),
            method="logits", mutable=True)
        got = tm.logits(_t(ids[:, i:i + 1]), _t(pos[:, i:i + 1]), cache=cache)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    assert int(cache.index) == 8


def test_lm_head_narrow_table_is_widened_in_chunks(monkeypatch):
    """A bf16 table gives the same fp32 product as widening it whole."""
    from d9d_tpu_torch.nn import heads

    monkeypatch.setattr(heads, "_LOGITS_VOCAB_CHUNK", 24)
    head = heads.LanguageModellingHead(VOCAB_RANGES, E, dtype=torch.bfloat16,
                                       device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    h = torch.randn(2, 3, E, generator=torch.Generator().manual_seed(1)).bfloat16()
    got = head.logits(h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.detach().numpy(), (h.float() @ head.weight.float().T).detach().numpy(), rtol=1e-6
    )


def test_load_jax_params_rejects_leftover_missing_and_misshapen():
    _, params, tm = _model_pair()
    flat = _flat(params)
    extra = dict(flat, **{"model/layers_0/self_attn/extra_proj/kernel":
                          np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra_proj"):
        load_jax_params(tm, extra)
    short = {k: v for k, v in flat.items() if not k.endswith("o_proj/kernel")}
    with pytest.raises(KeyError, match="o_proj"):
        load_jax_params(tm, short)
    nohead = {k: v for k, v in flat.items() if k != "lm_head/head_special"}
    with pytest.raises(KeyError, match="head_special"):
        load_jax_params(tm, nohead)
    bad = dict(flat)
    bad["model/norm/weight"] = np.zeros((E + 1,), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(tm, bad)


def test_sdpa_factory_and_device_default():
    assert build_sdpa_backend(SdpaEagerConfig()).__name__ == "eager_sdpa"
    assert hasattr(build_sdpa_backend(), "eager_calls")
    with pytest.raises(NotImplementedError, match="ring"):
        build_sdpa_backend(SdpaRingConfig())
    if not torch.cuda.is_available():
        # device=None means the card, and raises where there is none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Qwen3DenseCausalLM(Qwen3DenseConfig.tiny())


def _moments_and_bound(w, fan_in):
    w = w.detach().double().flatten()
    # flax's truncated lecun normal: a normal truncated at +-2 sigma' with
    # sigma' = fan_in^-0.5 / 0.8796..., so the variance is 1 / fan_in
    bound = 2.0 * fan_in**-0.5 / 0.87962566103423978
    return float(w.mean()), float(w.var()) * fan_in, float(w.abs().max()) / bound


def test_projection_and_head_init_is_jax_truncated_lecun_normal():
    """Seeded draws: mean 0, variance 1/fan_in within 2 %, every value
    inside the truncation bound and the largest near it (a normal with the
    same variance would overshoot it ~1.3 % of the time per value). fan_in
    is the first axis of the JAX tables: ``in_features`` for a projection
    (flax kernel ``[in, out]``), each vocab range's size for the LM head
    (``head_<range>`` is ``[size, hidden]``)."""
    from d9d_tpu_torch.nn.heads import LanguageModellingHead
    from d9d_tpu_torch.nn.linear import Projection

    gen = torch.Generator().manual_seed(0)
    proj = Projection(512, 256, dtype=torch.float32, device="cpu",
                      generator=gen)
    head = LanguageModellingHead((("text", 3000), ("special", 500)), 96,
                                 dtype=torch.float32, device="cpu",
                                 generator=gen)
    tables = [(proj.weight, 512), (head.weight[:3000], 3000),
              (head.weight[3000:], 500)]
    for w, fan_in in tables:
        mean, var_ratio, bound_ratio = _moments_and_bound(w, fan_in)
        assert abs(mean) < 3 * (fan_in**-0.5) / np.sqrt(w.numel())
        assert abs(var_ratio - 1.0) < 0.02
        assert 0.97 < bound_ratio <= 1.0
    # the JAX initializer's own draws have the same moments and bound
    jw = jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (512, 256))
    mean, var_ratio, bound_ratio = _moments_and_bound(
        torch.from_numpy(np.array(jw)), 512)
    assert abs(var_ratio - 1.0) < 0.02 and 0.97 < bound_ratio <= 1.0


def test_parameters_are_trainable_and_serving_builds_no_graph():
    """Every parameter requires grad (the training path needs them to);
    ``generate``, ``logits`` and the batcher run under no_grad: nothing is
    saved for a backward and every ``.grad`` stays None."""
    from d9d_tpu_torch.loop import ContinuousBatcher, generate

    tm = Qwen3DenseCausalLM(
        Qwen3DenseConfig(vocab_ranges=(("default", 64),), hidden_size=32,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=8, intermediate_size=64, use_sinks=True),
        decode_max_length=24, dtype=torch.float32, device="cpu", seed=3)
    params = list(tm.parameters())
    assert params and all(p.requires_grad for p in params)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        ids = torch.randint(0, 64, (2, 6), generator=torch.Generator().manual_seed(0))
        out = generate(tm, ids, max_new_tokens=4, prompt_lengths=torch.tensor([6, 3]),
                       prefill_chunk_size=4)
        logits = tm.logits(ids, torch.arange(6)[None].expand(2, 6),
                           cache=tm.init_cache(2))
        batcher = ContinuousBatcher(tm, batch_size=2, chunk_size=2)
        for prompt in ([1, 2, 3], [4, 5], [6]):
            batcher.submit(prompt, max_new_tokens=3)
        streams = batcher.drain()
    assert out.shape == (2, 4) and len(streams) == 3
    assert not saved
    assert not out.requires_grad and logits.grad_fn is None
    assert all(p.grad is None for p in params)
