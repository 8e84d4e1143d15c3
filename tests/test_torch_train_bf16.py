"""Training with bf16 parameters through the port (``param_dtype=bfloat16``,
``StochasticAdamW``, the train step's fp32 accumulators) vs the JAX package
on the CPU.

- Every parameter of the port's Qwen3 dense and MoE models is held in the
  dtype of its leaf in the JAX tree (bf16 projections, tables, experts and
  q/k norms; fp32 layer norms), compared through ``load_jax_params``'s own
  name mapping, and a bf16 JAX tree loads bit for bit.
- The port's ``Trainer`` against the JAX ``Trainer``, tiny dense and tiny
  MoE, fp32 compute, bf16 parameters, ``StochasticAdamW``. Step 1's loss and
  grad norm agree within the trainer tolerance of the fp32 slice (rtol
  1e-4): the parameters are the same and nothing has been rounded yet.
  From step 2 on the two runs hold parameters rounded with different noise
  (the JAX key stream against the port's counter hash): each element lies
  on one of the two bf16 values around fp32 values that agree closely, the
  differences have random sign, and loss and grad norm average over
  thousands of elements; they agree within 4e-3 relative, one bf16 ulp
  (2^-8), which a systematic fault (a missed rounding, a round to nearest,
  a gradient cast before accumulation) exceeds. The parameter dtypes stay
  those of the JAX tree.
- ``AdamW`` on bf16 parameters against ``optax.adamw`` on bf16 parameters at
  step 1 (gradients cast to bf16, moments in bf16): within 2 bf16 ulps, as
  the two frameworks round bf16 arithmetic at other places.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.loop import CausalLMTask as JCausalLMTask
from d9d_tpu.loop import DatasetProvider as JDatasetProvider
from d9d_tpu.loop import ModelProvider as JModelProvider
from d9d_tpu.loop import OptimizerProvider as JOptimizerProvider
from d9d_tpu.loop import Trainer as JTrainer
from d9d_tpu.loop import TrainerConfig as JTrainerConfig
from d9d_tpu.loop.auto import StochasticAdamWConfig as JStochasticAdamWConfig
from d9d_tpu.loop.auto import build_optimizer as j_build_optimizer
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JQwen3DenseCausalLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JQwen3DenseConfig
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.parallel import replicate_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
    StochasticAdamWConfig,
    Trainer,
    TrainerConfig,
    build_optimizer,
    build_train_step,
)
from d9d_tpu_torch.loop.control.task import TrainTask
from d9d_tpu_torch.model_state.from_jax import jax_param_map, load_jax_params
from d9d_tpu_torch.models.qwen3 import (
    Qwen3DenseCausalLM,
    Qwen3DenseConfig,
    Qwen3MoeCausalLM,
    Qwen3MoeConfig,
)
from d9d_tpu_torch.nn.sdpa import SdpaEagerConfig, build_sdpa_backend
from d9d_tpu_torch.ops.stochastic import stochastic_round_to_bf16
from d9d_tpu_torch.optim import AdamW

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
ROUNDED_STEP_TOL = dict(rtol=2.0 ** -8, atol=0.0)
GBS, MBS, SEQ, LR, WD = 4, 2, 16, 1e-2, 0.1

_MODELS = {
    "dense": (JQwen3DenseCausalLM, JQwen3DenseConfig.tiny(),
              Qwen3DenseCausalLM, Qwen3DenseConfig.tiny()),
    "moe": (JQwen3MoeCausalLM, JQwen3MoeConfig.tiny(64),
            Qwen3MoeCausalLM, Qwen3MoeConfig.tiny(64)),
}


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at the larger magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got - want) / spacing


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _port_model(kind):
    tcls, tcfg = _MODELS[kind][2:]
    return tcls(tcfg, build_sdpa_backend(SdpaEagerConfig()),
                dtype=torch.float32, param_dtype=torch.bfloat16, device="cpu",
                seed=None)


@pytest.fixture(scope="module")
def jax_trees():
    """The flattened bf16-parameter flax tree of each tiny model."""
    out = {}
    for kind, (jcls, jcfg, _, _) in _MODELS.items():
        jm = jcls(config=jcfg, sdpa=j_eager_sdpa, dtype=jnp.float32,
                  param_dtype=jnp.bfloat16)
        z = jnp.zeros((1, 8), jnp.int32)
        out[kind] = _flat(flax_meta.unbox(
            jm.init(jax.random.PRNGKey(0), z, z, z))["params"])
    return out


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_parameter_dtypes_match_the_jax_tree(jax_trees, kind):
    flat = jax_trees[kind]
    model = _port_model(kind)
    params = dict(model.named_parameters())
    mapping = jax_param_map(model, flat)
    assert set(mapping) == set(params)
    dtypes = {str(flat[k].dtype) for ks in mapping.values() for k in ks}
    assert dtypes == {"bfloat16", "float32"}
    for name, keys in mapping.items():
        for key in keys:
            assert str(params[name].dtype) == f"torch.{flat[key].dtype}", (
                name, key)
    # q/k norms follow param_dtype; the layer norms stay fp32, as in JAX
    attn = model.model.layers[0].self_attn
    assert attn.q_norm.weight.dtype == attn.k_norm.weight.dtype == torch.bfloat16
    assert model.model.layers[0].input_layernorm.weight.dtype == torch.float32


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_bf16_tree_loads_bit_for_bit(jax_trees, kind):
    flat = jax_trees[kind]
    model = _port_model(kind)
    load_jax_params(model, flat)
    params = dict(model.named_parameters())
    for name, keys in jax_param_map(model, flat).items():
        got = params[name].detach()
        if got.dtype != torch.bfloat16:
            continue
        want = np.concatenate([flat[k].view(np.int16) for k in keys])
        if keys[0].endswith("/kernel"):
            want = want.T
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want,
                                      err_msg=name)


def _batches(vocab, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (GBS, SEQ + 1))}
            for _ in range(steps)]


class _JData(JDatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


class _TData(DatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


class _JModel(JModelProvider):
    def __init__(self, kind):
        self.kind = kind

    def build_module(self, stage):
        jcls, jcfg = _MODELS[self.kind][:2]
        return jcls(config=jcfg, sdpa=j_eager_sdpa, stage=stage,
                    dtype=jnp.float32, param_dtype=jnp.bfloat16)

    def build_plan(self, ctx):
        return replicate_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _TModel(ModelProvider):
    def __init__(self, kind, flat):
        self.kind, self.flat = kind, flat

    def build_module(self, ctx):
        model = _port_model(self.kind)
        load_jax_params(model, self.flat)
        return model


class _JOpt(JOptimizerProvider):
    def build(self, learning_rate):
        return j_build_optimizer(JStochasticAdamWConfig(weight_decay=WD),
                                 learning_rate)


class _TOpt(OptimizerProvider):
    def build(self, params, learning_rate):
        return build_optimizer(StochasticAdamWConfig(weight_decay=WD), params,
                               learning_rate)


@pytest.mark.parametrize("kind,steps", [("dense", 5), ("moe", 3)])
def test_trainer_matches_jax_trainer_with_stochastic_adamw(kind, steps):
    vocab = _MODELS[kind][3].vocab_size
    batches = _batches(vocab, steps)
    common = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
                  total_steps=steps, log_every=1, max_grad_norm=1.0, seed=0)
    jtr = JTrainer(
        ctx=JMeshParameters().build(jax.devices()[:1]),
        config=JTrainerConfig(**common, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(kind), dataset_provider=_JData(batches),
        task=JCausalLMTask(), optimizer_provider=_JOpt(), learning_rate=LR)
    init = _flat(jtr.params)
    ttr = Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(**common),
        model_provider=_TModel(kind, init), dataset_provider=_TData(batches),
        task=CausalLMTask(), optimizer_provider=_TOpt(), learning_rate=LR)
    before = stochastic_round_to_bf16.plain_calls
    jh, th = jtr.train(), ttr.train()
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(
        range(1, steps + 1))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(th[0][key], jh[0][key], **STEP_TOL,
                                   err_msg=key)
        np.testing.assert_allclose([h[key] for h in th[1:]],
                                   [h[key] for h in jh[1:]],
                                   **ROUNDED_STEP_TOL, err_msg=key)
    # one rounding per bf16 parameter per step, none for the fp32 norms
    n_bf16 = sum(p.dtype == torch.bfloat16 for p in ttr.module.parameters())
    assert stochastic_round_to_bf16.plain_calls - before == steps * n_bf16
    final = _flat(jtr.params["params"])
    params = dict(ttr.module.named_parameters())
    for name, keys in jax_param_map(ttr.module, final).items():
        assert str(params[name].dtype) == f"torch.{final[keys[0]].dtype}"


class _LinearTask(TrainTask):
    def prepare_batch(self, batch):
        return batch

    def loss_fn(self, module, mb):
        w = mb["weight"].sum()
        return (module.w.float() * mb["c"].sum(0)).sum(), w, {}


class _Recorder:
    def __init__(self, params, fp32):
        self.params = list(params)
        self.seen = None
        if fp32:
            self.accepts_fp32_grads = True

    def step(self, grads=None):
        self.seen = (list(grads) if grads is not None
                     else [p.grad for p in self.params])


@pytest.mark.parametrize("fp32", [False, True])
def test_narrow_parameters_accumulate_in_fp32(fp32):
    """Per-microbatch bf16 gradients add into an fp32 accumulator: two
    microbatches whose bf16 gradients sum to a value bf16 cannot hold. An
    optimizer that accepts fp32 gradients gets the fp32 sum; any other gets
    it cast to bf16 in ``.grad``."""
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))
    opt = _Recorder(module.parameters(), fp32)
    step = build_train_step(module=module, task=_LinearTask(), optimizer=opt,
                            num_microbatches=2, max_grad_norm=None)
    c = [[1.0, 256.0], [2.0 ** -8, 1.0]]  # 256 + 1 is not a bf16 value
    step([{"c": torch.tensor([ci]), "weight": torch.tensor([0.5])}
          for ci in c])
    (g,) = opt.seen
    want = torch.tensor([1.0 + 2.0 ** -8, 257.0])
    if fp32:
        assert g.dtype == torch.float32 and torch.equal(g, want)
    else:
        assert g.dtype == torch.bfloat16 and torch.equal(g, want.bfloat16())
        assert module.w.grad is g


def test_adamw_on_bf16_parameters_matches_optax_at_step_1():
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((6, 5), (9,))]
    g0 = [rng.standard_normal(p.shape).astype(np.float32) for p in p0]
    jp = [jnp.asarray(p).astype(jnp.bfloat16) for p in p0]
    jg = [jnp.asarray(g).astype(jnp.bfloat16) for g in g0]
    tx = optax.adamw(2e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    state = tx.init(jp)
    upd, state = tx.update(jg, state, jp)
    jnew = optax.apply_updates(jp, upd)
    params = [torch.nn.Parameter(torch.from_numpy(p).bfloat16()) for p in p0]
    opt = AdamW(params, 2e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for p, g in zip(params, g0):
        p.grad = torch.from_numpy(g).bfloat16()
    opt.step()
    adam = state[0]
    for mine, theirs in ((params, jnew), (opt.mu, adam.mu), (opt.nu, adam.nu)):
        for t, j in zip(mine, theirs):
            assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
            assert bf16_ulps(t.detach().float().numpy(),
                             np.asarray(j.astype(jnp.float32))).max() <= 2
