"""Pipeline parallelism through the port's ``Trainer``: gloo processes on
the CPU against JAX's ``Trainer`` in this process.

The models are JAX's ``tests/loop/test_pp_train.py`` tiny Qwen3 dense (4
layers) and ``Qwen3MoeConfig.tiny()``'s widths (2 layers, local
experts). Every port run starts from the JAX trainer's initial weights,
carried into its stage modules (``model_state/from_jax.py``
``load_jax_stage_params``), and trains 2 steps; loss, grad norm and loss
weight of each step sit within ``STEP_TOL`` of the JAX trainer on one
device (the JAX package holds its pp trainer to that same flat run in its
own ``tests/loop/test_pp_train.py``):

- ``pp 2`` (2 processes): dense under the default schedule (GPipe), MoE
  under ZeroBubbleV with ``cache_acts``;
- ``pp 2 x dp_shard 2`` (4 processes): dense under ZB1P with
  ``cache_acts``, MoE under DualPipeV with ``cache_full``; and under
  ``fsdp_plan`` (each stage's FSDP units over its 2 ``dp_s`` ranks, FSDP's
  reduction run by hand once a step): dense under ZeroBubbleV with
  ``cache_acts``, MoE under Interleaved1F1B.

The 4-process spawn also checks, as JAX's ``test_pp_checkpoint_resume
_bitwise`` does, that a ``pp 2 x dp_shard 2`` run stopped after its first
step and resumed from its checkpoint gives the uninterrupted run's later
losses and final parameters bit for bit; and, as JAX's
``test_pp_virtual_stages_and_export``, that ``looped_bfs`` with 2
virtual stages a rank trains and that its export through the HF mapper
has exactly the names of a flat export, every global layer among them;
the export of the ``fsdp_plan`` run (stages cut over their ranks) has them
too and loads into the flat model.
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
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.parallel import replicate_plan as j_replicate_plan
from d9d_tpu_torch.model_state.io.module import load_params, save_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.models.qwen3.huggingface import (
    qwen3_dense_from_hf_mapper,
    qwen3_dense_to_hf_mapper,
)
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
VOCAB, STEPS, GBS, MBS, SEQ, LR = 64, 2, 16, 4, 16, 1e-2
DENSE = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32,
             num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8,
             intermediate_size=64, remat=False)
MOE = dict(vocab_ranges=(("default", VOCAB),), hidden_size=64, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=16, moe_intermediate_size=64,
           num_experts=8, num_experts_per_tok=2, remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=STEPS, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight")
# name: (mesh, model, schedule, plan)
CASES = {
    "dense_pp2": (dict(pp=2), "dense", None, "replicate"),
    "moe_pp2": (dict(pp=2), "moe",
                {"type": "zero_bubble_v", "residual_policy": "cache_acts"},
                "replicate"),
    "dense_pp2_dp2": (dict(pp=2, dp_shard=2), "dense",
                      {"type": "zero_bubble_1p",
                       "residual_policy": "cache_acts"}, "replicate"),
    "moe_pp2_dp2": (dict(pp=2, dp_shard=2), "moe",
                    {"type": "dual_pipe_v", "residual_policy": "cache_full"},
                    "replicate"),
    "dense_pp2_fsdp2": (dict(pp=2, dp_shard=2), "dense",
                        {"type": "zero_bubble_v",
                         "residual_policy": "cache_acts"}, "fsdp"),
    "moe_pp2_fsdp2": (dict(pp=2, dp_shard=2), "moe",
                      {"type": "interleaved_1f1b"}, "fsdp"),
}

WORKER = r'''
import json
import sys
import hashlib

import numpy as np
import torch

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, StatefulDataLoader, Trainer,
                                TrainerConfig)
from d9d_tpu_torch.model_state.from_jax import load_jax_stage_params
from d9d_tpu_torch.models.qwen3 import (Qwen3DenseCausalLM, Qwen3DenseConfig,
                                        Qwen3MoeCausalLM, Qwen3MoeConfig)
from d9d_tpu_torch.models.qwen3.huggingface import qwen3_dense_to_hf_mapper
from d9d_tpu_torch.parallel import fsdp_plan, replicate_plan
from d9d_tpu_torch.parallel.shards import is_sharded
from d9d_tpu_torch.pipelining import PipelineStageInfo

torch.set_num_threads(1)
rank, world, rdzv, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
spec = json.load(open(src + ".json"))
data = np.load(src + ".npz")
batches = [{"input_ids": data[f"ids{i}"]} for i in range(spec["steps"])]
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")


def config(kind):
    cfg = dict(spec[kind])
    cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
    return (Qwen3DenseConfig if kind == "dense" else Qwen3MoeConfig)(**cfg)


class Model(ModelProvider):
    def __init__(self, kind, plan="replicate"):
        self.kind, self.plan = kind, plan

    def build_module(self, ctx, stage=PipelineStageInfo()):
        cls = Qwen3DenseCausalLM if self.kind == "dense" else Qwen3MoeCausalLM
        return cls(config(self.kind), dtype=torch.float32, device=ctx.device,
                   seed=0, stage=stage)

    def build_plan(self, ctx):
        return {"fsdp": fsdp_plan, "replicate": replicate_plan}[self.plan](ctx)


class Data(DatasetProvider):
    def build(self):
        return iter(batches)


class Items:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"input_ids": rng.integers(0, spec["vocab"], (spec["seq"] + 1,))}


class Loader(DatasetProvider):
    def build(self):
        return StatefulDataLoader(Items(), spec["train"]["global_batch_size"],
                                  shuffle=True, seed=7, num_epochs=None)


def trainer(mesh, kind, schedule, loader=None, plan="replicate", **over):
    ctx = MeshParameters(**mesh).build(["cpu"] * world)
    cfg = TrainerConfig(**dict(spec["train"], pipeline=schedule, **over))
    tr = Trainer(ctx=ctx, config=cfg, model_provider=Model(kind, plan),
                 dataset_provider=loader or Data(), task=CausalLMTask(),
                 optimizer_provider=AdamWProvider(), learning_rate=spec["lr"])
    flat = {k[len(kind) + 1:]: data[k] for k in data.files
            if k.startswith(kind + "/")}
    mods = {s: rt.module for s, rt in tr.pp_engine.stages.items()}
    load_jax_stage_params(mods, {s: flat for s in mods})
    return tr


def digest(tr):
    h = hashlib.sha256()
    for name, p in sorted(tr.merged_params().items()):
        h.update(name.encode())
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


out = {}
for name, (mesh, kind, schedule, plan) in spec["cases"].items():
    if int(np.prod(list(mesh.values()))) != world:
        continue
    tr = trainer(mesh, kind, schedule, plan=plan)
    out[f"{name}/sharded"] = np.array(
        [is_sharded(p) for p in tr.merged_params().values()])
    hist = tr.train()
    # the forward-only program over the trained stages
    out[f"{name}/eval"] = np.array(tr.loss_on_batch(batches[0]))
    if name == "dense_pp2_fsdp2":  # an export from FSDP-cut stages
        tr.export(spec["tmp"] + "/export_fsdp",
                  mapper=qwen3_dense_to_hf_mapper(config("dense")))
    for key in spec["keys"]:
        out[f"{name}/{key}"] = np.array([h[key] for h in hist])
    out[f"{name}/stages"] = np.array(sorted(tr.pp_engine.stages))

if world == 4:
    mesh = dict(pp=2, dp_shard=2)
    tmp = spec["tmp"]
    full = trainer(mesh, "dense", {"type": "gpipe"}, loader=Loader(),
                   total_steps=3, checkpoint_dir=tmp + "/a",
                   checkpoint_every_steps=1, checkpoint_async=False)
    h_full = full.train()
    full.close()
    part = trainer(mesh, "dense", {"type": "gpipe"}, loader=Loader(),
                   total_steps=1, checkpoint_dir=tmp + "/b",
                   checkpoint_every_steps=1, checkpoint_async=False)
    part.train()
    part.close()
    resumed = trainer(mesh, "dense", {"type": "gpipe"}, loader=Loader(),
                      total_steps=3, checkpoint_dir=tmp + "/b",
                      checkpoint_every_steps=1, checkpoint_async=False)
    h_res = resumed.train()
    resumed.close()
    out["resume/full"] = np.array([h["loss"] for h in h_full[1:]])
    out["resume/resumed"] = np.array([h["loss"] for h in h_res])
    out["resume/steps"] = np.array([h["step"] for h in h_res])
    out["resume/digest_full"] = np.array(digest(full))
    out["resume/digest_resumed"] = np.array(digest(resumed))

    bfs = trainer(mesh, "dense", {"type": "looped_bfs", "stages_per_rank": 2},
                  total_steps=1)
    out["bfs/loss"] = np.array([h["loss"] for h in bfs.train()])
    out["bfs/stages"] = np.array(sorted(bfs.pp_engine.stages))
    bfs.export(tmp + "/export", mapper=qwen3_dense_to_hf_mapper(config("dense")))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


class _JModel(JModelProvider):
    def __init__(self, kind):
        self.kind = kind

    def build_module(self, stage):
        if self.kind == "dense":
            return JQwen3DenseCausalLM(config=JQwen3DenseConfig(**DENSE),
                                       sdpa=j_eager_sdpa, stage=stage,
                                       dtype=jnp.float32)
        return JQwen3MoeCausalLM(config=JQwen3MoeConfig(**MOE),
                                 sdpa=j_eager_sdpa, stage=stage,
                                 dtype=jnp.float32)

    def build_plan(self, ctx):
        return j_replicate_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _JData(JDatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


def _batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, VOCAB, (GBS, SEQ + 1))}
            for _ in range(STEPS)]


def _jax_run(kind, batches):
    """JAX's trainer on one device → (initial flat parameters, history)."""
    ctx = JMeshParameters().build(jax.devices()[:1])
    jtr = JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(kind), dataset_provider=_JData(batches),
        task=JCausalLMTask(), optimizer_provider=JAdamWProvider(),
        learning_rate=LR)
    flat = {k[len("params/"):]: np.asarray(v)
            for k, v in flatten_dict(jtr.params, sep="/").items()}
    hist = jtr.train()
    return flat, {k: np.array([h[k] for h in hist]) for k in KEYS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    batches = _batches()
    arrays = {f"ids{i}": b["input_ids"] for i, b in enumerate(batches)}
    jax_runs = {}
    starts = []
    # the weights first: the workers start from them
    for kind in ("dense", "moe"):
        flat, hist = _jax_run(kind, batches)
        jax_runs[kind] = hist
        arrays.update({f"{kind}/{k}": v for k, v in flat.items()})
    np.savez(tmp / "run.npz", **arrays)
    (tmp / "run.json").write_text(json.dumps(dict(
        dense=dict(DENSE, vocab_ranges=[list(r) for r in DENSE["vocab_ranges"]]),
        moe=dict(MOE, vocab_ranges=[list(r) for r in MOE["vocab_ranges"]]),
        train=TRAIN, steps=STEPS, lr=LR, keys=KEYS, vocab=VOCAB, seq=SEQ,
        tmp=str(tmp), cases={n: list(c) for n, c in CASES.items()})))
    for world in (2, 4):
        sub = tmp / f"spawn{world}"
        sub.mkdir()
        starts.append((world, spawn(sub, WORKER, world, tmp / "run",
                                    tmp / f"out{world}_")))
    ranks = {}
    for world, wait in starts:
        wait()
        ranks[world] = [dict(np.load(tmp / f"out{world}_{r}.npz"))
                        for r in range(world)]
    return dict(jax=jax_runs, ranks=ranks, tmp=tmp)


@pytest.mark.parametrize("name", list(CASES))
def test_pp_trainer_matches_jax(runs, name):
    mesh, kind, _, plan = CASES[name]
    world = int(np.prod(list(mesh.values())))
    ranks = runs["ranks"][world]
    for r in ranks:  # every rank reports the same history
        for key in KEYS:
            np.testing.assert_array_equal(r[f"{name}/{key}"],
                                          ranks[0][f"{name}/{key}"])
    for key in KEYS:
        np.testing.assert_allclose(ranks[0][f"{name}/{key}"],
                                   runs["jax"][kind][key], **STEP_TOL,
                                   err_msg=f"{name}: {key}")
    # under fsdp_plan each stage's layers are cut over its dp_s ranks
    assert ranks[0][f"{name}/sharded"].any() == (plan == "fsdp")
    # the forward-only loss of the first batch after training: the same on
    # every rank, and below the first step's loss
    evals = [float(r[f"{name}/eval"]) for r in ranks]
    assert evals == [evals[0]] * len(evals)
    assert np.isfinite(evals[0]) and evals[0] < ranks[0][f"{name}/loss"][0]


def test_pp_stage_ownership(runs):
    """ZeroBubbleV and DualPipeV put stages r and 2·pp-1-r on rank r; the
    other schedules stage r."""
    two, four = runs["ranks"][2], runs["ranks"][4]
    assert [list(r["dense_pp2/stages"]) for r in two] == [[0], [1]]
    assert [list(r["moe_pp2/stages"]) for r in two] == [[0, 3], [1, 2]]
    assert [list(r["moe_pp2_dp2/stages"]) for r in four] == [
        [0, 3], [0, 3], [1, 2], [1, 2]]
    assert [list(r["bfs/stages"]) for r in four] == [
        [0, 2], [0, 2], [1, 3], [1, 3]]


def test_pp_checkpoint_resume_bitwise(runs):
    for r in runs["ranks"][4]:
        assert list(r["resume/steps"]) == [2, 3]
        np.testing.assert_array_equal(r["resume/resumed"], r["resume/full"])
        assert str(r["resume/digest_resumed"]) == str(r["resume/digest_full"])


def test_pp_virtual_stages_and_export(runs, tmp_path):
    """looped_bfs at 2 stages a rank trains; its HF export has exactly a
    flat export's names."""
    assert all(np.isfinite(r["bfs/loss"]).all() for r in runs["ranks"][4])
    cfg = Qwen3DenseConfig(**DENSE)
    flat = Qwen3DenseCausalLM(cfg, dtype=torch.float32, device="cpu")
    save_params(tmp_path / "flat", flat, mapper=qwen3_dense_to_hf_mapper(cfg))

    def names(d):
        return set(json.loads((d / "model.safetensors.index.json")
                              .read_text())["weight_map"])

    got = names(runs["tmp"] / "export")
    assert got == names(tmp_path / "flat")
    for layer in range(cfg.num_layers):
        assert any(n.startswith(f"model.layers.{layer}.") for n in got)
    # the export of stages cut by fsdp_plan holds each parameter whole:
    # it loads into the flat model (names and shapes checked)
    assert names(runs["tmp"] / "export_fsdp") == got
    load_params(runs["tmp"] / "export_fsdp", flat,
                mapper=qwen3_dense_from_hf_mapper(cfg))
