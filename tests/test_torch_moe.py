"""MoE blocks of the PyTorch port (``nn/moe.py``: router, expert
initializer, MoE layer) vs the JAX package on the CPU in float32, with the
flax weights carried across by ``load_jax_params`` (which raises on a key
left over and on a parameter left without a value).

Tolerances: rtol/atol 1e-5 for the router's probabilities and the MoE
layer's outputs and gradients. Router indices and the load counts are
compared exactly. The whole model is in ``test_torch_moe_model.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as jnn
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

from d9d_tpu.nn.moe import MoELayer as JMoELayer
from d9d_tpu.nn.moe import SharedExpertParameters as JShared
from d9d_tpu.nn.moe import TopKRouter as JTopKRouter
from d9d_tpu_torch.model_state import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn import (
    GroupedSwiGLU,
    MoELayer,
    SharedExpertParameters,
    TopKRouter,
    collect_tokens_per_expert,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# router


@pytest.mark.parametrize("case", ["plain", "no_renorm", "expert_bias",
                                  "group_limited", "integer_ties"])
def test_router_matches_jax(case):
    d, e, k = 16, 16, 4
    kw = dict(renormalize_probabilities=case != "no_renorm",
              enable_expert_bias=case == "expert_bias",
              n_group=4 if case == "group_limited" else 1,
              topk_group=2 if case == "group_limited" else 1)
    rng = np.random.default_rng(0)
    jr = JTopKRouter(dim=d, num_experts=e, top_k=k, dtype=jnp.float32, **kw)
    x = rng.standard_normal((3, 40, d)).astype(np.float32)
    variables = flax_meta.unbox(jr.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params = {"params": variables["params"]}
    if case == "integer_ties":
        # integer logits from integer weights and inputs: most rows hold tied
        # scores, and lax.top_k takes tied experts lower index first
        x = rng.integers(-2, 3, (3, 40, d)).astype(np.float32)
        params = {"params": {"gate": {"kernel": jnp.asarray(
            rng.integers(-1, 2, (d, e)).astype(np.float32))}}}
    if case == "expert_bias":
        params["moe_buffers"] = {"expert_bias": jnp.asarray(
            rng.standard_normal(e).astype(np.float32) * 0.05)}
    jidx, jprobs = jr.apply(params, jnp.asarray(x))

    tr = TopKRouter(d, e, k, dtype=torch.float32, param_dtype=torch.float32,
                    device="cpu", **kw)
    load_jax_params(tr, _flat(params["params"]))
    if case == "expert_bias":
        tr.expert_bias.copy_(_t(params["moe_buffers"]["expert_bias"]))
        assert "expert_bias" not in dict(tr.named_parameters())
    idx, probs = tr(_t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jprobs),
                               **TOL)
    if case == "integer_ties":
        scores = x @ np.asarray(params["params"]["gate"]["kernel"])
        top = np.take_along_axis(scores, np.asarray(jidx), -1)
        ties = (top[..., :, None] == top[..., None, :]).sum(-1) > 1
        assert ties.mean() > 0.2  # the case holds many ties


# ---------------------------------------------------------------------------
# initializer


def test_expert_initializer_moments_beside_jax_draws():
    """flax's variance_scaling(1/3, fan_in, uniform, in_axis=1, out_axis=2)
    counts the expert axis as receptive field: fan-in E * in, so the draw is
    uniform on +-sqrt(1 / (E * in)), variance 1 / (3 E in)."""
    e, din, dout = 16, 256, 64
    init = jnn.initializers.variance_scaling(1.0 / 3.0, "fan_in", "uniform",
                                             in_axis=1, out_axis=2)
    jw = np.asarray(init(jax.random.PRNGKey(0), (e, din, dout), jnp.float32))
    experts = GroupedSwiGLU(din, dout, e, dtype=torch.float32,
                            param_dtype=torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    tw = experts.gate_proj.detach().numpy()
    bound = (1.0 / (e * din)) ** 0.5
    var = 1.0 / (3 * e * din)
    for w in (jw, tw):
        assert np.abs(w).max() <= bound
        assert np.abs(w).max() > 0.999 * bound
        assert abs(w.var() / var - 1) < 0.02
        assert abs(w.mean()) < 0.01 * bound
    down = experts.down_proj.detach().numpy()
    assert np.abs(down).max() <= (1.0 / (e * dout)) ** 0.5
    # the router's gate is the lecun-normal projection
    tr = TopKRouter(din, e, 2, device="cpu", param_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    assert abs(tr.gate.weight.detach().numpy().var() * din - 1) < 0.05


# ---------------------------------------------------------------------------
# the MoE layer


LAYER_CASES = {
    "aligned": dict(moe_ffn="aligned"),
    "gather": dict(moe_ffn="gather"),
    "gather_combine": dict(moe_ffn="gather_combine"),
    "aligned_shared_gated_scaled": dict(
        moe_ffn="aligned", shared=(48, True), routed_scaling=2.5),
    "gather_combine_shared": dict(moe_ffn="gather_combine", shared=(48, False)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax_and_counts_tokens_per_expert(case):
    spec = LAYER_CASES[case]
    d, inter, e, k = 64, 64, 8, 2
    shared = spec.get("shared")
    scale = spec.get("routed_scaling", 1.0)
    jl = JMoELayer(
        hidden_dim=d, intermediate_dim_grouped=inter, num_grouped_experts=e,
        top_k=k, routed_scaling=scale, dtype=jnp.float32,
        shared_expert=JShared(*shared) if shared else None)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    params = {"params": flax_meta.unbox(
        jl.init(jax.random.PRNGKey(2), jnp.asarray(x)))["params"]}
    jout, updates = jl.apply(params, jnp.asarray(x), mutable=["moe_stats"])
    leaf = updates["moe_stats"]["tokens_per_expert"]
    jcounts = np.asarray(leaf[0] if isinstance(leaf, tuple) else leaf)

    tl = MoELayer(d, inter, e, k, routed_scaling=scale,
                  shared_expert=SharedExpertParameters(*shared) if shared
                  else None, moe_ffn=spec["moe_ffn"], dtype=torch.float32,
                  param_dtype=torch.float32, device="cpu")
    load_jax_params(tl, _flat(params["params"]))
    with collect_tokens_per_expert(tl) as counts:
        out = tl(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert len(counts) == 1
    np.testing.assert_array_equal(counts[0].numpy(), jcounts)
    tl(_t(x))  # outside the window: nothing is counted
    assert len(counts) == 1

    # gradients of the layer's input and every parameter, against jax.grad
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return (jl.apply(p, xx) * cot).sum()

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (tl(xt) * _t(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **TOL)
    want = MoELayer(d, inter, e, k, routed_scaling=scale,
                    shared_expert=SharedExpertParameters(*shared) if shared
                    else None, dtype=torch.float32,
                    param_dtype=torch.float32, device="cpu")
    load_jax_params(want, _flat(jg_p["params"]))
    got = dict(tl.named_parameters())
    for name, g in want.named_parameters():
        np.testing.assert_allclose(got[name].grad.numpy(),
                                   g.detach().numpy(), **TOL, err_msg=name)


def test_unported_layer_and_config_options_raise():
    """What still raises: GDN, MLA, the remat policies other than "full",
    serving a model built with ep_axes (ROADMAP A10), and an EP layer that
    no mesh was bound to. Expert parallelism itself builds (its training is
    tests/test_torch_ep.py's), and so does KV-cache decode, which makes its
    cache."""
    from d9d_tpu_torch.loop import ContinuousBatcher, generate

    with pytest.raises(ValueError, match="moe_ffn"):
        MoELayer(64, 64, 8, 2, moe_ffn="xla", device="cpu")
    base = Qwen3MoeConfig.tiny()
    for field, value in (("linear_attention_layers", (0,)),
                         ("mla", object())):
        with pytest.raises(NotImplementedError, match=field):
            Qwen3MoeCausalLM(dataclasses.replace(base, **{field: value}),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        Qwen3MoeCausalLM(dataclasses.replace(
            base, remat=True, remat_policy="save_expensive"), device="cpu")
    for field, value in (("ep_axes", ("dp_s",)),
                         ("moe_token_axes", (("dp_s",), ("cp_s",)))):
        ep = Qwen3MoeCausalLM(dataclasses.replace(base, **{field: value}),
                              decode_max_length=64, dtype=torch.float32,
                              device="cpu")
        if field == "ep_axes":
            with pytest.raises(NotImplementedError, match="ROADMAP A10"):
                generate(ep, torch.zeros((1, 4), dtype=torch.int64),
                         max_new_tokens=2)
            with pytest.raises(NotImplementedError, match="ROADMAP A10"):
                ContinuousBatcher(ep, batch_size=2)
    layer = MoELayer(64, 64, 8, 2, ep_axes=("dp_s",), dtype=torch.float32,
                     device="cpu")
    with pytest.raises(RuntimeError, match="bind_expert_parallel"):
        layer(torch.zeros((1, 4, 64)))
    served = Qwen3MoeCausalLM(base, decode_max_length=64, device="cpu")
    cache = served.init_cache(2)
    assert cache.keys[0].shape[-2] == 64


def test_grouped_swiglu_matches_jax():
    """The unfused expert chain on expert-sorted rows (GroupedSwiGLU,
    grouped_swiglu_apply), with empty experts."""
    from d9d_tpu.nn.moe import GroupedSwiGLU as JGroupedSwiGLU
    from d9d_tpu.ops.moe import sort_tokens_by_expert as j_sort

    from d9d_tpu_torch.ops.moe import sort_tokens_by_expert

    d, inter, e = 32, 48, 8
    rng = np.random.default_rng(6)
    ids = rng.choice([0, 2, 3, 7], (30, 2)).astype(np.int32)
    x = rng.standard_normal((60, d)).astype(np.float32)
    probs = rng.random(60).astype(np.float32)
    js = j_sort(jnp.asarray(ids), e)
    jg = JGroupedSwiGLU(hidden_dim=d, intermediate_dim=inter, num_experts=e,
                        dtype=jnp.float32)
    params = flax_meta.unbox(jg.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                     jnp.asarray(probs), js.group_sizes))
    want = jg.apply(params, jnp.asarray(x), jnp.asarray(probs),
                    js.group_sizes)
    tg = GroupedSwiGLU(d, inter, e, dtype=torch.float32,
                       param_dtype=torch.float32, device="cpu")
    load_jax_params(tg, _flat(params["params"]))
    got = tg(_t(x), _t(probs),
             sort_tokens_by_expert(torch.from_numpy(ids), e).group_sizes)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
