"""The training slice of the port (``loop/train.py`` ``Trainer`` and what it
drives) vs the JAX package's ``Trainer`` on the CPU.

Both trainers run on one device from the same initial parameters (the JAX
trainer initializes them; the port's model provider carries them across
with ``load_jax_params``), on the same batches, with the same config: 2
microbatches, a clip that fires at every step, weight decay, a piecewise
warmup schedule and a ``loss_mask``. fp32 throughout. Per-step loss and
grad norm agree within rtol 1e-4 (the JAX and PyTorch CPU kernels sum in
different orders; Adam's normalized update carries those last-bit
differences from step to step); final parameters within rtol/atol 1e-3.
The JAX flash backend runs its Pallas kernels in interpret mode; the port's
runs its kernels' plain versions.
"""
import dataclasses

import numpy as np
import optax
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
from d9d_tpu.lr_scheduler.config import (
    PiecewiseSchedulerConfig as JPiecewiseSchedulerConfig,
)
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JQwen3DenseCausalLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JQwen3DenseConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.ops.attention.pallas_flash import make_pallas_flash_sdpa
from d9d_tpu.parallel import replicate_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWConfig,
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    PiecewiseLRConfig,
    StochasticAdamWConfig,
    Trainer,
    TrainerConfig,
    build_lr_schedule,
    build_optimizer,
    build_train_step,
)
from d9d_tpu_torch.loop.control.task import TrainTask
from d9d_tpu_torch.lr_scheduler import (
    CurveCosineConfig,
    CurveLinearConfig,
    PiecewiseSchedulerConfig,
    RestPhaseConfig,
    StepPhaseConfig,
)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.sdpa import SdpaEagerConfig, SdpaFlashConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.optim import AdamW
from d9d_tpu_torch.pipelining import (
    GPipeScheduleConfig,
    LoopedBFSScheduleConfig,
    ZeroBubbleVScheduleConfig,
)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
STEPS, GBS, MBS, SEQ = 5, 4, 2, 16
MAX_GRAD_NORM = 0.05
BASE_LR, WD = 1e-2, 0.1

# the tiny() config, and the dense _flagship shape of __graft_entry__.py at
# 2 layers (with full remat and a 3-chunk CE, so both recompute paths run)
_SHAPES = {
    "tiny": dict(vocab=64, hidden_size=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, intermediate_size=128, remat=False,
                 ce_chunk_size="auto"),
    "flagship_2l": dict(vocab=8192, hidden_size=512, num_heads=8,
                        num_kv_heads=4, head_dim=64, intermediate_size=1536,
                        remat=True, ce_chunk_size=12),
}


def _batches(vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, (GBS, SEQ + 1))
        mask = (rng.random((GBS, SEQ + 1)) > 0.25).astype(np.int32)
        out.append({"input_ids": ids, "loss_mask": mask})
    return out


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
    def __init__(self, cfg, sdpa, ce_chunk_size):
        self.cfg, self.sdpa, self.ce = cfg, sdpa, ce_chunk_size

    def build_module(self, stage):
        return JQwen3DenseCausalLM(config=self.cfg, sdpa=self.sdpa, stage=stage,
                                   ce_chunk_size=self.ce, dtype=jnp.float32)

    def build_plan(self, ctx):
        return replicate_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _TModel(ModelProvider):
    def __init__(self, cfg, sdpa_cfg, ce_chunk_size, flat):
        self.cfg, self.sdpa_cfg, self.ce, self.flat = (
            cfg, sdpa_cfg, ce_chunk_size, flat)

    def build_module(self, ctx):
        model = Qwen3DenseCausalLM(
            self.cfg, build_sdpa_backend(self.sdpa_cfg), dtype=torch.float32,
            param_dtype=torch.float32, ce_chunk_size=self.ce,
            device=ctx.device, seed=None)
        load_jax_params(model, self.flat)
        return model


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _schedules():
    j = JPiecewiseLRConfig(base_lr=BASE_LR, schedule=JPiecewiseSchedulerConfig(
        initial_multiplier=0.1,
        phases=[{"mode": "steps", "steps": 2, "target_multiplier": 1.0,
                 "curve": {"type": "linear"}},
                {"mode": "rest", "target_multiplier": 0.2,
                 "curve": {"type": "cosine"}}]))
    t = PiecewiseLRConfig(base_lr=BASE_LR, schedule=PiecewiseSchedulerConfig(
        initial_multiplier=0.1,
        phases=(StepPhaseConfig(2, 1.0, CurveLinearConfig()),
                RestPhaseConfig(0.2, CurveCosineConfig()))))
    return (j_build_lr_schedule(j, total_steps=STEPS),
            build_lr_schedule(t, total_steps=STEPS))


def test_lr_schedule_matches_jax_step_by_step():
    j, t = _schedules()
    for step in range(STEPS + 2):
        assert float(t(step)) == pytest.approx(float(j(step)), rel=1e-6)


# both backends at the tiny shape; the flagship shape through the flash one
@pytest.mark.parametrize("shape,backend", [
    ("tiny", "eager"), ("tiny", "flash"), ("flagship_2l", "flash")])
def test_trainer_matches_jax_trainer_step_by_step(shape, backend):
    spec = dict(_SHAPES[shape])
    vocab, remat, ce = spec.pop("vocab"), spec.pop("remat"), spec.pop("ce_chunk_size")
    jcfg = JQwen3DenseConfig(vocab_ranges=(("default", vocab),), num_layers=2,
                             remat=remat, **spec)
    tcfg = Qwen3DenseConfig(vocab_ranges=(("default", vocab),), num_layers=2,
                            remat=remat, **spec)
    jsdpa = (j_eager_sdpa if backend == "eager"
             else make_pallas_flash_sdpa(block_q=8, block_kv=8))
    tsdpa = SdpaEagerConfig() if backend == "eager" else SdpaFlashConfig()
    batches = _batches(vocab)
    j_lr, t_lr = _schedules()
    common = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
                  total_steps=STEPS, max_grad_norm=MAX_GRAD_NORM, log_every=1,
                  seed=0)

    jtr = JTrainer(
        ctx=JMeshParameters().build(jax.devices()[:1]),
        config=JTrainerConfig(**common, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(jcfg, jsdpa, ce),
        dataset_provider=_JData(batches), task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD),
        learning_rate=j_lr,
    )
    init = _flat(jtr.params)
    ttr = Trainer(
        ctx=MeshParameters().build(["cpu"]),
        config=TrainerConfig(**common),
        model_provider=_TModel(tcfg, tsdpa, ce, init),
        dataset_provider=_TData(batches), task=CausalLMTask(),
        optimizer_provider=AdamWProvider(weight_decay=WD),
        learning_rate=t_lr,
    )
    jh, th = jtr.train(), ttr.train()
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(
        range(1, STEPS + 1))
    for key in ("loss", "grad_norm", "loss_weight", "task/tokens"):
        np.testing.assert_allclose([h[key] for h in th], [h[key] for h in jh],
                                   **STEP_TOL, err_msg=key)
    # the clip fired at every step, and the loss_mask dropped labels
    assert min(h["grad_norm"] for h in th) > MAX_GRAD_NORM
    assert all(h["loss_weight"] < MBS * (GBS // MBS) * SEQ for h in th)

    want = Qwen3DenseCausalLM(tcfg, build_sdpa_backend(tsdpa),
                              dtype=torch.float32, param_dtype=torch.float32,
                              device="cpu", seed=None)
    load_jax_params(want, _flat(jtr.params))
    got = dict(ttr.module.named_parameters())
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=name)
    if backend == "flash":
        assert ttr.module.sdpa.eager_calls == 0


def test_adamw_matches_optax_at_step_0_and_step_3():
    """Update k uses schedule(k) — the count before the increment — and
    weight decay reaches every parameter."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    lrs = [0.1, 0.02, 0.3, 0.05]
    sched = lambda k: jnp.asarray(lrs, jnp.float32)[k]  # noqa: E731
    tx = optax.adamw(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = AdamW(params, lambda k: lrs[k], b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1)
    for k in range(4):
        upd, state = tx.update([jnp.asarray(g) for g in grads[k]], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(params, grads[k]):
            p.grad = torch.from_numpy(g)
        opt.step()
        if k in (0, 3):
            for p, w in zip(params, jp):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
    assert opt.count == 4


class _LinearTask(TrainTask):
    """loss_sum = w . c: the gradient of a microbatch is exactly its c."""

    def prepare_batch(self, batch):
        return batch

    def loss_fn(self, module, mb):
        w = mb["weight"].sum()
        return (module.w * mb["c"].sum(0)).sum(), w, {"n": w}


class _Recorder:
    """An optimizer that records the grads it is handed."""

    def __init__(self, params):
        self.params = list(params)
        self.seen = None

    def step(self):
        self.seen = [p.grad.clone() for p in self.params]


def _linear_step(max_grad_norm, c_list, weights):
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.zeros(3))
    opt = _Recorder(module.parameters())
    step = build_train_step(module=module, task=_LinearTask(), optimizer=opt,
                            num_microbatches=len(c_list),
                            max_grad_norm=max_grad_norm)
    mbs = [{"c": torch.tensor([c], dtype=torch.float32),
            "weight": torch.tensor([w], dtype=torch.float32)}
           for c, w in zip(c_list, weights)]
    return step(mbs), opt.seen[0]


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_clip_is_min_one_max_over_norm(where):
    c = [3.0, 4.0, 0.0]  # one microbatch, weight 1: grad norm 5
    max_norm = {"below": 10.0, "at": 5.0, "above": 2.0}[where]
    metrics, grad = _linear_step(max_norm, [c], [1.0])
    assert float(metrics["grad_norm"]) == pytest.approx(5.0)
    factor = min(1.0, max_norm / max(5.0, 1e-12))
    np.testing.assert_allclose(grad.numpy(), np.asarray(c) * factor,
                               rtol=1e-6)


def test_sum_then_scale_weighs_microbatches_by_their_weight():
    c1, c2 = [1.0, 0.0, 2.0], [0.0, 4.0, -2.0]
    metrics, grad = _linear_step(None, [c1, c2], [1.0, 3.0])
    want = (np.asarray(c1) + np.asarray(c2)) / 4.0  # not mean of means
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-6)
    assert float(metrics["loss_weight"]) == 4.0
    assert float(metrics["task/n"]) == 4.0


# fields of the JAX config whose features are ported since this test was
# written (checkpointing, prefetch and the pipeline schedule): their cases
# keep their ids and now check that the value is accepted and kept
_PORTED_FIELDS = {"checkpoint_dir", "prefetch_batches", "pipeline"}


@pytest.mark.parametrize("field,value", [
    ("pipeline", ZeroBubbleVScheduleConfig(residual_policy="cache_acts")),
    ("checkpoint_dir", "ckpt"), ("profile_dir", "p"),
    ("anomaly_policy", "skip_step"), ("telemetry_dir", "t"),
    ("metrics_port", 0), ("numerics_every_steps", 1),
    ("pp_timeline_every_steps", 1), ("zero_sharding", True),
    ("split_optimizer_update", True), ("handle_preemption", True),
    ("telemetry_console", True), ("prefetch_batches", 2),
    ("step_timeout_s", 10.0), ("reshard_hbm_budget_mb", 512.0),
])
def test_unported_config_fields_raise(field, value):
    kw = dict(global_batch_size=4, microbatch_size=2, seq_len=8, total_steps=1)
    TrainerConfig(**kw)  # the defaults are fine
    if field in _PORTED_FIELDS:
        assert getattr(TrainerConfig(**kw, **{field: value}), field) == value
        return
    with pytest.raises(NotImplementedError, match=field):
        TrainerConfig(**kw, **{field: value})


# TrainerConfig defaults that differ from the JAX package's (ROADMAP C2):
# each turns on a feature the port does not have yet, so the port keeps it
# off; the reference's default comes back when the feature is ported
# (prefetch_batches came back with batch prefetch)
_DIVERGENT_DEFAULTS = {
    "handle_preemption": (False, True),
    "telemetry_console": (False, True),
}


def test_trainer_config_defaults_match_jax_except_the_pinned_three():
    """Every field both configs have carries the reference's default,
    except exactly the ones pinned above (three until prefetch was
    ported, two now); another divergence fails."""
    port = {f.name: f.default for f in dataclasses.fields(TrainerConfig)
            if f.default is not dataclasses.MISSING}
    ref = {name: f.default for name, f in JTrainerConfig.model_fields.items()
           if not f.is_required()}
    differ = {name: (port[name], ref[name]) for name in port
              if name in ref and port[name] != ref[name]}
    assert differ == _DIVERGENT_DEFAULTS
    assert set(port) <= set(ref), set(port) - set(ref)


def test_unported_options_raise():
    assert isinstance(build_optimizer(AdamWConfig(), [], 1e-3), AdamW)
    # a pp mesh asks for the process group, as an ep mesh does; pp beside
    # tp or ep_shard raises before any group is asked for, naming the
    # ROADMAP item that ports it; a dict schedule becomes its config and
    # an unknown schedule type raises
    for kw in (dict(pp=2), dict(pp=2, dp_shard=2),
               dict(dp_shard=2, ep_shard=2)):
        with pytest.raises(RuntimeError, match="needs a process group"):
            MeshParameters(**kw).build(
                ["cpu"] * MeshParameters(**kw).world_size)
    for kw in (dict(pp=2, tp=2), dict(pp=2, dp_shard=2, ep_shard=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A8.2"):
            MeshParameters(**kw).build(
                ["cpu"] * MeshParameters(**kw).world_size)
    kw = dict(global_batch_size=4, microbatch_size=2, seq_len=8,
              total_steps=1)
    assert TrainerConfig(**kw, pipeline={"type": "looped_bfs",
                                         "stages_per_rank": 2}).pipeline \
        == LoopedBFSScheduleConfig(stages_per_rank=2)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TrainerConfig(**kw, pipeline={"type": "one_f_one_b"})
    # JAX's runtime key: the per-action executor is its "legacy" one
    assert TrainerConfig(**kw, pipeline={"type": "gpipe",
                                         "runtime": "legacy"}).pipeline \
        == GPipeScheduleConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP A8.2"):
        TrainerConfig(**kw, pipeline={"type": "gpipe", "runtime": "fused"})
    # fused_qkv under tp > 1 raises JAX's error where the plan cuts heads
    from d9d_tpu_torch.core.mesh import MeshContext
    from d9d_tpu_torch.parallel import apply_plan, tp_plan

    tp_ctx = MeshContext(params=MeshParameters(tp=2),
                         device=torch.device("cpu"))
    fused = Qwen3DenseCausalLM(
        dataclasses.replace(Qwen3DenseConfig.tiny(), fused_qkv=True),
        device="meta")
    with pytest.raises(ValueError, match="fused_qkv=True under a tp>1 mesh"):
        apply_plan(fused, tp_ctx, tp_plan(tp_ctx))
    cfg = dataclasses.replace(Qwen3DenseConfig.tiny(), remat=True,
                              remat_policy="dots_no_batch")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        Qwen3DenseCausalLM(cfg, device="cpu")
    module = torch.nn.Linear(2, 2)
    for kw in (dict(anomaly_policy="warn"), dict(split_update=True),
               dict(numerics=True), dict(zero=object())):
        with pytest.raises(NotImplementedError):
            build_train_step(module=module, task=_LinearTask(),
                             optimizer=None, num_microbatches=1, **kw)


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert MeshParameters().build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshParameters().build()
    assert MeshParameters().build(["cpu"]).device == torch.device("cpu")
