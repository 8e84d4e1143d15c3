"""Context-parallel training of the port: ``Trainer`` at ``cp_shard=2`` in 2
gloo processes on the CPU vs the JAX ``Trainer`` on ``MeshParameters(
cp_shard=2)`` with the ring backend (the counterpart of
``tests/loop/test_cp_train.py``, on the ``cp_s`` axis alone), and vs the
port's own one-process ``Trainer``.

Config: ``tests/loop/test_cp_train.py``'s model (hidden 32, 2 layers, 4/2
heads of 8, vocab 32), seq 32, 4 steps, here with 2 microbatches, a
``loss_mask`` (the ranks' chunks then weigh different token counts) and
weight decay. The JAX trainer initializes the weights; both port runs load
them with ``load_jax_params``. The JAX ring runs its flash block in Pallas
interpret mode, the port's ring the kernels' plain versions. Per-step loss
and grad norm within rtol 1e-4 and final parameters within rtol/atol 1e-3,
as ``tests/test_torch_train.py`` holds the one-device trainers (sums in
other orders, carried from step to step by Adam's normalized update). Both
ranks' histories and parameters are equal bit for bit: every rank applies
the same all-reduced sums. The workers then train ``Qwen3MoeConfig.tiny``
with expert parallelism over ``cp_s`` in the legacy flow (each rank's
piece of JAX's flattened global batch holds rows of both ranks) against
the port's one-process MoE run, loss, grad norm and load fraction within
the same rtol.
"""
import json

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
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JQwen3DenseCausalLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JQwen3DenseConfig
from d9d_tpu.nn.sdpa import SdpaRingConfig as JSdpaRingConfig
from d9d_tpu.nn.sdpa import build_sdpa_backend as j_build_sdpa_backend
from d9d_tpu.parallel import replicate_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    Trainer,
    TrainerConfig,
)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import (
    Qwen3DenseCausalLM,
    Qwen3DenseConfig,
    Qwen3MoeCausalLM,
    Qwen3MoeConfig,
)
from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
VOCAB, STEPS, GBS, MBS, SEQ, LR, WD = 32, 4, 4, 2, 32, 1e-2, 0.1
MODEL = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=8, intermediate_size=64,
             remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=STEPS, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/tokens")
MOE_KEYS = ("loss", "grad_norm", "task/moe_load_max_frac")


def _batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, VOCAB, (GBS, SEQ + 1)),
             "loss_mask": (rng.random((GBS, SEQ + 1)) > 0.3).astype(np.int32)}
            for _ in range(STEPS)]


WORKER = r'''
import json
import sys

import numpy as np
import torch

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, Trainer, TrainerConfig)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import (Qwen3DenseCausalLM, Qwen3DenseConfig,
                                        Qwen3MoeCausalLM, Qwen3MoeConfig)
from d9d_tpu_torch.nn.sdpa import SdpaRingConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.ops.attention.flash import flash_attention
from d9d_tpu_torch.ops.attention.ring import ring_attention
from d9d_tpu_torch.parallel import fsdp_ep_plan

torch.set_num_threads(1)
rank, world, rdzv, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
spec = json.load(open(src + ".json"))
data = np.load(src + ".npz")
flat = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
batches = [{"input_ids": data[f"ids{i}"], "loss_mask": data[f"mask{i}"]}
           for i in range(spec["steps"])]
out = {}

# no process group yet: a cp mesh refuses to build
try:
    MeshParameters(cp_shard=world).build(["cpu"] * world)
except RuntimeError as e:
    out["no_group_refused"] = np.bool_("process group" in str(e))
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
try:
    MeshParameters(cp_shard=2 * world).build(["cpu"] * 2 * world)
except RuntimeError as e:
    out["mismatch_refused"] = np.bool_("process group of" in str(e))
ctx = MeshParameters(cp_shard=world).build(["cpu"] * world)


class Model(ModelProvider):
    def build_module(self, ctx):
        cfg = dict(spec["model"])
        cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
        model = Qwen3DenseCausalLM(
            Qwen3DenseConfig(**cfg),
            build_sdpa_backend(SdpaRingConfig(head_axes=()), ctx=ctx),
            dtype=torch.float32, param_dtype=torch.float32,
            device=ctx.device, seed=rank)  # other weights on each rank ...
        if rank == 0:  # ... until rank 0's reach every rank
            load_jax_params(model, flat)
        return model


class MoeModel(ModelProvider):
    # expert parallelism over cp_s in the legacy flow (token_axes=None):
    # JAX flattens the global batch, which is no rank's own block here, so
    # the layers regroup its pieces (nn/moe.py LegacyPieces)
    def build_module(self, ctx):
        return Qwen3MoeCausalLM(
            Qwen3MoeConfig.tiny(32, ep_axes=ctx.ep_shard_axes),
            build_sdpa_backend(SdpaRingConfig(head_axes=()), ctx=ctx),
            dtype=torch.float32, device=ctx.device, seed=0)

    def build_plan(self, ctx):
        return fsdp_ep_plan(ctx)


class LocalAttentionModel(ModelProvider):
    def build_module(self, ctx):
        return Qwen3DenseCausalLM(Qwen3DenseConfig.tiny(32),
                                  dtype=torch.float32, device=ctx.device)


class Data(DatasetProvider):
    def build(self):
        return iter(batches)


ring_attention.skipped_blocks = 0
flash_attention.plain_calls = 0
trainer = Trainer(
    ctx=ctx, config=TrainerConfig(**spec["train"]), model_provider=Model(),
    dataset_provider=Data(), task=CausalLMTask(),
    optimizer_provider=AdamWProvider(weight_decay=spec["wd"]),
    learning_rate=spec["lr"])
hist = trainer.train()
for key in spec["keys"]:
    out[f"hist/{key}"] = np.array([h[key] for h in hist])
out["hist/tokens_per_s_positive"] = np.bool_(all(h["tokens_per_s"] > 0
                                                 for h in hist))
for name, p in trainer.module.named_parameters():
    out[f"p/{name}"] = p.detach().numpy()
out["skipped_blocks"] = np.int64(ring_attention.skipped_blocks)
out["plain_fwd"] = np.int64(flash_attention.plain_calls)
out["eval_loss"] = np.float64(trainer.loss_on_batch(batches[0]))
moe = Trainer(ctx=MeshParameters(cp_shard=world, ep_shard=world).build(
                  ["cpu"] * world),
              config=TrainerConfig(**spec["train"]), model_provider=MoeModel(),
              dataset_provider=Data(), task=CausalLMTask(),
              optimizer_provider=AdamWProvider(weight_decay=spec["wd"]),
              learning_rate=spec["lr"])
moe_hist = moe.train()
for key in spec["moe_keys"]:
    out[f"moe/{key}"] = np.array([h[key] for h in moe_hist])
try:
    Trainer(ctx=ctx, config=TrainerConfig(**spec["train"]),
            model_provider=LocalAttentionModel(), dataset_provider=Data(),
            task=CausalLMTask(), optimizer_provider=AdamWProvider())
except ValueError as e:
    out["local_attention_refused"] = np.bool_("ring backend" in str(e))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


class _JModel(JModelProvider):
    def __init__(self, sdpa):
        self.sdpa = sdpa

    def build_module(self, stage):
        return JQwen3DenseCausalLM(config=JQwen3DenseConfig(**MODEL),
                                   sdpa=self.sdpa, stage=stage,
                                   dtype=jnp.float32)

    def build_plan(self, ctx):
        return replicate_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


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


class _TModel(ModelProvider):
    def __init__(self, flat):
        self.flat = flat

    def build_module(self, ctx):
        model = Qwen3DenseCausalLM(
            Qwen3DenseConfig(**MODEL), build_sdpa_backend(SdpaFlashConfig()),
            dtype=torch.float32, param_dtype=torch.float32,
            device=ctx.device, seed=None)
        load_jax_params(model, self.flat)
        return model


class _MoeOneProcess(ModelProvider):
    def build_module(self, ctx):
        return Qwen3MoeCausalLM(Qwen3MoeConfig.tiny(32), dtype=torch.float32,
                                device=ctx.device, seed=0)


def _jax_cp_trainer(batches):
    ctx = JMeshParameters(cp_shard=2).build(jax.devices()[:2])
    ring = j_build_sdpa_backend(JSdpaRingConfig(
        seq_axis="cp_s", batch_axes=("dp_r", "dp_s"), head_axes=()))
    return JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(ring), dataset_provider=_JData(batches),
        task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)


def test_cp_trainer_matches_jax_cp_trainer_and_one_process(tmp_path):
    batches = _batches()
    jtr = _jax_cp_trainer(batches)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(jtr.params, sep="/").items()}
    src = tmp_path / "run"
    arrays = {f"w/{k}": v for k, v in flat.items()}
    for i, b in enumerate(batches):
        arrays[f"ids{i}"], arrays[f"mask{i}"] = b["input_ids"], b["loss_mask"]
    np.savez(f"{src}.npz", **arrays)
    (tmp_path / "run.json").write_text(json.dumps(dict(
        model=MODEL, train=TRAIN, steps=STEPS, lr=LR, wd=WD, keys=KEYS,
        moe_keys=MOE_KEYS)))
    wait = spawn(tmp_path, WORKER, 2, src, tmp_path / "out")

    jh = jtr.train()  # meanwhile: the JAX cp run, then the port on one process
    ttr = Trainer(ctx=MeshParameters().build(["cpu"]),
                  config=TrainerConfig(**TRAIN), model_provider=_TModel(flat),
                  dataset_provider=_TData(batches), task=CausalLMTask(),
                  optimizer_provider=AdamWProvider(weight_decay=WD),
                  learning_rate=LR)
    th = ttr.train()
    moe_one = Trainer(ctx=MeshParameters().build(["cpu"]),
                      config=TrainerConfig(**TRAIN),
                      model_provider=_MoeOneProcess(),
                      dataset_provider=_TData(batches), task=CausalLMTask(),
                      optimizer_provider=AdamWProvider(weight_decay=WD),
                      learning_rate=LR).train()
    wait()
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]

    r0, r1 = ranks
    for f in r0.files:  # both ranks: the same history and parameters
        if f.startswith(("hist/", "p/", "eval_loss")):
            np.testing.assert_array_equal(r0[f], r1[f], err_msg=f)
    for key in KEYS:
        got = r0[f"hist/{key}"]
        np.testing.assert_allclose(got, [h[key] for h in jh], **STEP_TOL,
                                   err_msg=f"vs JAX: {key}")
        np.testing.assert_allclose(got, [h[key] for h in th], **STEP_TOL,
                                   err_msg=f"vs one process: {key}")
    # the loss_mask dropped labels; the weights are global token counts
    assert all(w < GBS * SEQ for w in r0["hist/loss_weight"])
    assert bool(r0["hist/tokens_per_s_positive"])

    want = Qwen3DenseCausalLM(Qwen3DenseConfig(**MODEL), dtype=torch.float32,
                              param_dtype=torch.float32, device="cpu",
                              seed=None)
    load_jax_params(want, {k: np.asarray(v) for k, v in
                           flatten_dict(jtr.params, sep="/").items()})
    one = dict(ttr.module.named_parameters())
    for name, w in want.named_parameters():
        got = r0[f"p/{name}"]
        np.testing.assert_allclose(got, w.detach().numpy(), **PARAM_TOL,
                                   err_msg=f"vs JAX: {name}")
        np.testing.assert_allclose(got, one[name].detach().numpy(),
                                   **PARAM_TOL, err_msg=f"vs one process: {name}")

    # 2 layers x 2 microbatches x 4 steps = 16 ring calls: rank 0 runs its
    # diagonal chunk and skips the future one, rank 1 runs both (plain
    # versions on the CPU); each skip is counted again in the backward
    assert [int(r["plain_fwd"]) for r in ranks] == [16, 32]
    assert [int(r["skipped_blocks"]) for r in ranks] == [32, 0]
    # loss_on_batch after training: the global weighted loss on every rank
    assert float(r0["eval_loss"]) == pytest.approx(
        ttr.loss_on_batch(batches[0]), rel=1e-4)
    for flag in ("no_group_refused", "mismatch_refused",
                 "local_attention_refused"):
        assert bool(r0[flag]), flag
    # the legacy EP flow over cp_s (each rank's piece of JAX's flattened
    # batch is rows of both ranks) trains as the one-process MoE model
    for key in MOE_KEYS:
        np.testing.assert_array_equal(r0[f"moe/{key}"], r1[f"moe/{key}"])
        np.testing.assert_allclose(r0[f"moe/{key}"],
                                   [h[key] for h in moe_one], **STEP_TOL,
                                   err_msg=f"legacy EP over cp_s: {key}")


def test_cp_mesh_refusals():
    for kw in (dict(cp_shard=2), dict(dp_replicate=2, cp_shard=2),
               dict(cp_replicate=2), dict(cp_shard=2, tp=2)):
        with pytest.raises(RuntimeError, match="needs a process group"):
            MeshParameters(**kw).build(["cpu"] * MeshParameters(**kw).world_size)
    # pp beside cp raises before any process group is asked for
    for kw in (dict(cp_shard=2, pp=2), dict(cp_replicate=2, pp=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A8.2"):
            MeshParameters(**kw).build(["cpu"] * 4)
    # an ep mesh builds (over a process group); the legacy EP flow trains
    # on a cp mesh (the worker)
    with pytest.raises(RuntimeError, match="needs a process group"):
        MeshParameters(cp_shard=2, ep_shard=2).build(["cpu"] * 2)
    # the ring runs on each rank's head slice; heads that tp does not
    # divide raise JAX's divisibility error where the plan cuts them
    from d9d_tpu_torch.core.mesh import MeshContext
    from d9d_tpu_torch.nn.sdpa import SdpaRingConfig
    from d9d_tpu_torch.ops.attention.ring import make_ring_sdpa
    from d9d_tpu_torch.parallel import apply_plan, fsdp_plan

    tp_ctx = MeshContext(params=MeshParameters(cp_shard=2, tp=4),
                         device=torch.device("cpu"))
    ring = build_sdpa_backend(SdpaRingConfig(), ctx=tp_ctx)
    assert make_ring_sdpa(tp_ctx, head_axes=("tp",)).group is None
    model = Qwen3DenseCausalLM(Qwen3DenseConfig(**MODEL), ring,
                               device="meta")
    with pytest.raises(ValueError, match=r"heads \(q=4, kv=2\) not divisible "
                                         r"by the head axes \('tp',\) size 4"):
        apply_plan(model, tp_ctx, fsdp_plan(tp_ctx, with_tp=True))
    with pytest.raises(ValueError, match="not divisible"):
        from d9d_tpu_torch.loop.components.batch_staging import (
            check_cp_seq_len,
        )
        check_cp_seq_len(33, 2)
    with pytest.raises(ValueError, match="needs the mesh"):
        build_sdpa_backend(SdpaRingConfig())


def test_cp_batch_staging_cuts_sequence_leaves():
    """Rank r keeps positions [r*T/cp, (r+1)*T/cp) of every leaf whose dim 2
    is seq_len; positions stay global; other leaves stay whole."""
    from d9d_tpu_torch.loop.components.batch_staging import stage_microbatches

    ids = np.arange(4 * 9).reshape(4, 9)
    prepared = CausalLMTask().prepare_batch({"input_ids": ids})
    prepared["whole"] = np.ones((4, 3))
    for rank in range(2):
        mbs = stage_microbatches(prepared, num_microbatches=2,
                                 microbatch_size=2, device=torch.device("cpu"),
                                 seq_len=8, cp_size=2, cp_rank=rank)
        assert len(mbs) == 2
        sl = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(mbs[1]["tokens"], ids[2:, :-1][:, sl])
        np.testing.assert_array_equal(mbs[1]["labels"], ids[2:, 1:][:, sl])
        np.testing.assert_array_equal(mbs[0]["positions"][0],
                                      np.arange(8)[sl])
        assert mbs[0]["whole"].shape == (2, 3)
