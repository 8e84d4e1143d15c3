"""The port's ``Trainer`` training Qwen3-MoE vs the JAX package's ``Trainer``
on the CPU, step for step.

The model, optimizer and LR-schedule sections are those of
``example/qwen3_moe/pretrain.json`` (fp32, 4 layers, 16 experts, top-2,
hidden 128, expert width 128; AdamW b2 0.95, weight decay 0.01; piecewise
warmup from 0 over 10 steps, then cosine to 0.1 over the file's 40 steps),
on one device. The batch is cut from the file's 32 x 128 tokens in 4
microbatches of 8 rows to 16 x 128 tokens in 2 microbatches of 8 rows, and
the run to 3 steps, to keep the test inside its time; the schedule keeps
the file's total of 40 steps. Both trainers start from the same parameters (the JAX
trainer draws them; ``load_jax_params`` carries them across). The JAX model
runs the eager SDPA and the XLA expert chain; the port runs its flash and
fused expert-FFN kernels' plain versions, once for each ``moe_ffn`` value.
Loss, grad norm and ``task/moe_load_max_frac`` agree within rtol 1e-4 per
step (the trainer tolerance of the dense slice); the final parameters
within rtol/atol 1e-3, as in the dense slice's test.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.loop import AdamWProvider as JAdamWProvider
from d9d_tpu.loop import CausalLMTask as JCausalLMTask
from d9d_tpu.loop import DatasetProvider as JDatasetProvider
from d9d_tpu.loop import ModelProvider as JModelProvider
from d9d_tpu.loop import Trainer as JTrainer
from d9d_tpu.loop import TrainerConfig as JTrainerConfig
from d9d_tpu.loop.auto import PiecewiseLRConfig as JPiecewiseLRConfig
from d9d_tpu.loop.auto import build_lr_schedule as j_build_lr_schedule
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.parallel import replicate_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    PiecewiseLRConfig,
    Trainer,
    TrainerConfig,
    build_lr_schedule,
)
from d9d_tpu_torch.lr_scheduler import (
    CurveCosineConfig,
    CurveLinearConfig,
    PiecewiseSchedulerConfig,
    RestPhaseConfig,
    StepPhaseConfig,
)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "example/qwen3_moe/pretrain.json").read_text())
STEP_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
STEPS, GBS, MBS, SEQ = 3, 16, 8, 128


def _config_kwargs():
    m = SPEC["model"]
    assert m["dtype"] == "float32"
    return dict(
        vocab_ranges=(("default", m["vocab_size"]),),
        hidden_size=m["hidden_size"], num_layers=m["num_layers"],
        num_heads=m["num_heads"], num_kv_heads=m["num_kv_heads"],
        head_dim=m["head_dim"],
        moe_intermediate_size=m["moe_intermediate_size"],
        num_experts=m["num_experts"],
        num_experts_per_tok=m["num_experts_per_tok"], remat=m["remat"])


def _batches():
    rng = np.random.default_rng(0)
    vocab = SPEC["model"]["vocab_size"]
    return [{"input_ids": rng.integers(0, vocab, (GBS, SEQ + 1))}
            for _ in range(STEPS)]


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
    def build_module(self, stage):
        return JQwen3MoeCausalLM(config=JQwen3MoeConfig(**_config_kwargs()),
                                 sdpa=j_eager_sdpa, stage=stage,
                                 dtype=jnp.float32)

    def build_plan(self, ctx):
        return replicate_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _TModel(ModelProvider):
    def __init__(self, flat, moe_ffn):
        self.flat, self.moe_ffn = flat, moe_ffn

    def build_module(self, ctx):
        model = Qwen3MoeCausalLM(
            Qwen3MoeConfig(**_config_kwargs()), moe_ffn=self.moe_ffn,
            dtype=torch.float32, param_dtype=torch.float32, device=ctx.device,
            seed=None)
        load_jax_params(model, self.flat)
        return model


def _schedules():
    lr = SPEC["lr_scheduler"]
    sch = lr["schedule"]
    warm, rest = sch["phases"]
    total = SPEC["trainer"]["total_steps"]
    j = JPiecewiseLRConfig(base_lr=lr["base_lr"], schedule=sch)
    t = PiecewiseLRConfig(base_lr=lr["base_lr"], schedule=PiecewiseSchedulerConfig(
        initial_multiplier=sch["initial_multiplier"],
        phases=(StepPhaseConfig(warm["steps"], warm["target_multiplier"],
                                CurveLinearConfig()),
                RestPhaseConfig(rest["target_multiplier"],
                                CurveCosineConfig()))))
    return (j_build_lr_schedule(j, total_steps=total),
            build_lr_schedule(t, total_steps=total))


def _common():
    return dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
                total_steps=STEPS, log_every=1, seed=0)


def _opt():
    o = SPEC["optimizer"]
    assert o["type"] == "adamw"
    return dict(b2=o["b2"], weight_decay=o["weight_decay"])


@pytest.fixture(scope="module")
def jax_run():
    j_lr, _ = _schedules()
    jtr = JTrainer(
        ctx=JMeshParameters().build(jax.devices()[:1]),
        config=JTrainerConfig(**_common(), telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(), dataset_provider=_JData(_batches()),
        task=JCausalLMTask(), optimizer_provider=JAdamWProvider(**_opt()),
        learning_rate=j_lr,
    )
    def flat():
        return {k: np.asarray(v)
                for k, v in flatten_dict(jtr.params, sep="/").items()}

    init = flat()
    history = jtr.train()
    return init, history, flat()


@pytest.mark.parametrize("moe_ffn", ["aligned", "gather", "gather_combine"])
def test_moe_trainer_matches_jax_trainer_step_by_step(jax_run, moe_ffn):
    init, jh, final = jax_run
    _, t_lr = _schedules()
    ttr = Trainer(
        ctx=MeshParameters().build(["cpu"]),
        config=TrainerConfig(**_common()),
        model_provider=_TModel(init, moe_ffn),
        dataset_provider=_TData(_batches()), task=CausalLMTask(),
        optimizer_provider=AdamWProvider(**_opt()), learning_rate=t_lr,
    )
    th = ttr.train()
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(
        range(1, STEPS + 1))
    for key in ("loss", "grad_norm", "task/moe_load_max_frac"):
        np.testing.assert_allclose([h[key] for h in th], [h[key] for h in jh],
                                   **STEP_TOL, err_msg=key)
    e = SPEC["model"]["num_experts"]
    assert all(1.0 / e <= h["task/moe_load_max_frac"] <= 1.0 for h in th)
    assert ttr.optimizer.count == STEPS
    want = _TModel(final, moe_ffn).build_module(ttr.ctx)
    got = dict(ttr.module.named_parameters())
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=name)
