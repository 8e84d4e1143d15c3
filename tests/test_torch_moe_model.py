"""The Qwen3-MoE model of the PyTorch port (``models/qwen3/moe.py``) vs the
JAX package on the CPU in float32, with the flax weights carried across by
``load_jax_params``: per-token loss, logits and every parameter's gradient
within rtol/atol 1e-4 (as for the dense model), and the per-layer load
counts under full remat, exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn import collect_tokens_per_expert
from d9d_tpu_torch.nn.sdpa import SdpaEagerConfig, build_sdpa_backend

torch.set_num_threads(1)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(remat, moe_ffn="aligned"):
    kw = dict(vocab_ranges=(("default", 256),), hidden_size=64, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16,
              moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
              intermediate_size=96, mlp_only_layers=(1,), remat=remat)
    jm = JQwen3MoeCausalLM(config=JQwen3MoeConfig(**kw), sdpa=j_eager_sdpa,
                           dtype=jnp.float32)
    cfg = Qwen3MoeConfig(**kw)
    tm = Qwen3MoeCausalLM(cfg, build_sdpa_backend(SdpaEagerConfig()),
                          moe_ffn=moe_ffn, dtype=torch.float32,
                          param_dtype=torch.float32, device="cpu", seed=None)
    return jm, tm, cfg


def _inputs(b=2, t=16, vocab=256):
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, t)).astype(np.int32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return tokens, positions, labels


@pytest.mark.parametrize("moe_ffn", ["aligned", "gather_combine"])
def test_model_loss_logits_and_grads_match_jax(moe_ffn):
    """Qwen3MoeConfig.tiny widths, layer 1 dense (mlp_only_layers)."""
    jm, tm, cfg = _models(remat=False, moe_ffn=moe_ffn)
    tokens, positions, labels = _inputs()
    jargs = [jnp.asarray(a) for a in (tokens, positions, labels)]
    params = {"params": flax_meta.unbox(
        jm.init(jax.random.PRNGKey(0), *jargs))["params"]}
    load_jax_params(tm, _flat(params["params"]))
    assert type(tm.model.layers[1].mlp).__name__ == "SwiGLU"

    jloss = jm.apply(params, *jargs)
    jlogits = jm.apply(params, *jargs[:2], method=jm.logits)
    jgrads = jax.grad(lambda p: jm.apply(p, *jargs).sum())(params)

    targs = [_t(a).long() for a in (tokens, positions, labels)]
    loss = tm(*targs)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **MODEL_TOL)
    np.testing.assert_allclose(tm.logits(*targs[:2]).numpy(),
                               np.asarray(jlogits), **MODEL_TOL)
    loss.sum().backward()
    want = Qwen3MoeCausalLM(cfg, dtype=torch.float32,
                            param_dtype=torch.float32, device="cpu",
                            seed=None)
    load_jax_params(want, _flat(jgrads["params"]))
    got = dict(tm.named_parameters())
    for name, g in want.named_parameters():
        np.testing.assert_allclose(got[name].grad.numpy(), g.detach().numpy(),
                                   **MODEL_TOL, err_msg=name)


def test_load_counts_under_full_remat_count_each_layer_call_once():
    """Full remat recomputes each layer's forward in the backward; the
    collector counts the forward's calls only, and they equal JAX's sown
    counts (JAX under nn.remat too)."""
    kw = dict(vocab_ranges=(("default", 256),), hidden_size=64, num_layers=3,
              num_heads=4, num_kv_heads=2, head_dim=16,
              moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
              remat=True)
    jm = JQwen3MoeCausalLM(config=JQwen3MoeConfig(**kw), sdpa=j_eager_sdpa,
                           dtype=jnp.float32)
    tm = Qwen3MoeCausalLM(Qwen3MoeConfig(**kw), dtype=torch.float32,
                          param_dtype=torch.float32, device="cpu", seed=None)
    tokens, positions, labels = _inputs()
    jargs = [jnp.asarray(a) for a in (tokens, positions, labels)]
    params = {"params": flax_meta.unbox(
        jm.init(jax.random.PRNGKey(0), *jargs))["params"]}
    load_jax_params(tm, _flat(params["params"]))

    def jloss(p):
        out, upd = jm.apply(p, *jargs, mutable=["moe_stats"])
        return out.sum(), upd

    (_, updates), _ = jax.value_and_grad(jloss, has_aux=True)(params)
    jcounts = [np.asarray(v[0] if isinstance(v, tuple) else v)
               for _, v in sorted(_flat(updates["moe_stats"]).items())]
    targs = [_t(a).long() for a in (tokens, positions, labels)]
    with collect_tokens_per_expert(tm) as counts:
        loss = tm(*targs)
    loss.sum().backward()  # recomputes every layer
    assert len(counts) == len(jcounts) == 3
    for got, want in zip(counts, jcounts):
        np.testing.assert_array_equal(got.numpy(), want)
    assert all(int(c.sum()) == 2 * 16 * 2 for c in counts)
