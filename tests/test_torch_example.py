"""The example end to end: the port's twin of ``example/qwen3_moe/pretrain.py``
(``d9d_tpu_torch/example/qwen3_moe/pretrain.py``) on ``pretrain.json``'s
mesh, model, data and optimizer sections as they are, in 8 gloo processes
on the CPU, against the JAX example's own classes (``MoEProvider``,
``CorpusProvider``, ``build_lr_schedule``, ``ConfiguredOptimizerProvider``)
on the suite's 8 virtual devices.

Overridden: ``total_steps`` 6, ``log_every`` 1, ``checkpoint_every_steps``
3 and the three paths (into ``tmp_path``; the JAX side keeps no
checkpoint). The LR schedule spans the file's 40 steps on both sides (its
10-step warmup does not fit in 6: ``build_trainer(lr_total_steps=40)``).
The port starts from JAX's initial weights (``load_jax_params``).

- Per-step loss and grad norm are within ``tests/test_torch_ep.py``'s
  ``STEP_TOL`` (rtol 1e-4) of JAX's, all 6 steps; the 8 ranks' histories
  agree bit for bit.
- Interrupted at 3: the unbroken run saves ``save_3`` and ``save_6``; with
  ``save_6`` deleted a fresh trainer resumes from step 3 and trains to 6.
  On every rank its histories for steps 4–6 and its pieces of the
  parameters and the optimizer state (``mu``, ``nu``, ``count``) equal the
  unbroken run's bit for bit. Those pieces are FSDP's uneven ``Shard(0)``
  (``Replicate`` over ``dp_r``) and the ep-cut expert ``DTensor``s; a tiny
  dense model under ``fsdp_plan(with_tp=True)`` on the same mesh adds
  ``_StridedShard`` pieces (FSDP over the tp-cut vocab tables): one step,
  saved, restored by a fresh trainer, equal bit for bit.
- Cross-mesh restore: this process (no process group) restores both
  8-rank checkpoints onto one-process trainers of the same configs; every
  parameter and moment equals the 8 ranks' gathered value bit for bit.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.loop import CausalLMTask as JCausalLMTask
from d9d_tpu.loop import Trainer as JTrainer
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.example.qwen3_moe import pretrain as twin
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    ModelProvider,
    Trainer,
    TrainerConfig,
)
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "example/qwen3_moe/pretrain.json").read_text())
STEP_TOL = dict(rtol=1e-4, atol=0.0)
WORLD = 8
STEPS, EVERY = 6, 3
LR_STEPS = SPEC["trainer"]["total_steps"]


def _config(tmp):
    raw = json.loads(json.dumps(SPEC))
    raw["trainer"].update(total_steps=STEPS, log_every=1,
                          checkpoint_every_steps=EVERY,
                          checkpoint_dir=str(tmp / "ckpt"))
    raw["tracker"]["directory"] = str(tmp / "runs")
    raw["export_to"] = str(tmp / "export")
    return raw


WORKER = r'''
import dataclasses
import json
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.example.qwen3_moe import pretrain as twin
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, Trainer, TrainerConfig)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.parallel import fsdp_plan
from d9d_tpu_torch.parallel.shards import like_param, local_tensor

torch.set_num_threads(1)
rank, world, rdzv, cfg_path, weights_path, lr_steps, dst = sys.argv[1:8]
rank, world, lr_steps = int(rank), int(world), int(lr_steps)
raw = json.load(open(cfg_path))
cfg = twin.parse_config(raw)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
data = np.load(weights_path)
flat = {k: data[k] for k in data.files}
ctx = MeshParameters(**dataclasses.asdict(cfg.mesh)).build(["cpu"] * world)
out, clock = {}, [time.perf_counter()]


def tick(name):
    now = time.perf_counter()
    out[f"seconds/{name}"] = np.float64(now - clock[0])
    clock[0] = now


def pieces(trainer):
    # this rank's pieces: parameters, mu, nu; and count
    opt = trainer.optimizer
    got = {f"param/{n}": local_tensor(p).detach().clone()
           for n, p in trainer.module.named_parameters()}
    for n, m, v in zip(trainer._optimizer_param_names(), opt.mu, opt.nu):
        got[f"mu/{n}"], got[f"nu/{n}"] = m.clone(), v.clone()
    got["count"] = torch.tensor(opt.count)
    return got


def gathered(trainer, tag):
    # the whole values (a collective); rank 0 keeps them
    opt = trainer.optimizer
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                       else t).detach().numpy().copy()
    got = {f"{tag}/param/{n}": whole(p)
           for n, p in trainer.module.named_parameters()}
    for n, p, m, v in zip(trainer._optimizer_param_names(), opt.params,
                          opt.mu, opt.nu):
        got[f"{tag}/mu/{n}"] = whole(like_param(m, p))
        got[f"{tag}/nu/{n}"] = whole(like_param(v, p))
    got[f"{tag}/count"] = np.int64(opt.count)
    return got if rank == 0 else {}


def kinds(trainer):
    return {type(pl).__name__ for p in trainer.module.parameters()
            for pl in getattr(p, "placements", ())}


first = twin.build_trainer(cfg, ctx, lr_total_steps=lr_steps)
load_jax_params(first.module, flat)
seen = kinds(first)
tick("build")
hist = first.train()
first.close()
tick("unbroken")
for k in ("loss", "grad_norm"):
    out[f"unbroken/hist/{k}"] = np.array([h[k] for h in hist])
out["unbroken/steps"] = np.array([h["step"] for h in hist])
want = pieces(first)
del first
dist.barrier()
if rank == 0:
    shutil.rmtree(f"{raw['trainer']['checkpoint_dir']}/save_{len(hist)}")
dist.barrier()
resumed = twin.build_trainer(cfg, ctx, lr_total_steps=lr_steps)
hist = resumed.train()
resumed.close()
tick("resumed")
for k in ("loss", "grad_norm"):
    out[f"resumed/hist/{k}"] = np.array([h[k] for h in hist])
out["resumed/steps"] = np.array([h["step"] for h in hist])
got = pieces(resumed)
assert got.keys() == want.keys()
out["resumed/unequal"] = np.array(sorted(k for k in want
                                         if not torch.equal(got[k], want[k])))
out["resumed/pieces"] = np.int64(len(want))
out.update(gathered(resumed, "example"))
tick("gather")


class Dense(ModelProvider):
    # FSDP over tp-cut weights: _StridedShard pieces (the vocab tables)
    def build_module(self, c):
        return Qwen3DenseCausalLM(Qwen3DenseConfig.tiny(), dtype=torch.float32,
                                  device=c.device, seed=0)

    def build_plan(self, c):
        return fsdp_plan(c, with_tp=True)


class Batches(DatasetProvider):
    def build(self):
        rng = np.random.default_rng(0)
        return iter([{"input_ids": rng.integers(0, 256, (4, 17))}])


def dense():
    return Trainer(ctx=ctx, config=TrainerConfig(
        global_batch_size=4, microbatch_size=4, seq_len=16, total_steps=1,
        checkpoint_dir=f"{raw['trainer']['checkpoint_dir']}_dense",
        checkpoint_every_steps=1), model_provider=Dense(),
        dataset_provider=Batches(), task=CausalLMTask(),
        optimizer_provider=AdamWProvider(weight_decay=0.1),
        learning_rate=1e-2)


saved = dense()
seen |= kinds(saved)
saved.train()
saved.close()
want = pieces(saved)
again = dense()
assert again._restore_state() == 1
got = pieces(again)
out["dense/unequal"] = np.array(sorted(k for k in want
                                       if not torch.equal(got[k], want[k])))
out.update(gathered(again, "dense"))
out["kinds"] = np.array(sorted(seen))
tick("dense")
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_example_qwen3_moe_pretrain",
        ROOT / "example/qwen3_moe/pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_trainer(raw):
    """The JAX example's own classes on the suite's 8 virtual devices, no
    checkpoint dir."""
    jex = _jax_example()
    raw = json.loads(json.dumps(raw))
    raw["trainer"].update(checkpoint_dir=None, telemetry_console=False,
                          handle_preemption=False)
    cfg = jex.ProjectConfig.model_validate(raw)
    ctx = JMeshParameters(**cfg.mesh.model_dump()).build(jax.devices()[:WORLD])
    return JTrainer(
        ctx=ctx, config=cfg.trainer,
        model_provider=jex.MoEProvider(cfg.model, ctx),
        dataset_provider=jex.CorpusProvider(cfg.data, cfg.model.vocab_size,
                                            cfg.trainer),
        task=JCausalLMTask(),
        optimizer_provider=jex.ConfiguredOptimizerProvider(cfg.optimizer),
        learning_rate=jex.build_lr_schedule(cfg.lr_scheduler,
                                            total_steps=LR_STEPS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example")
    raw = _config(tmp)
    (tmp / "config.json").write_text(json.dumps(raw))
    jtr = _jax_trainer(raw)
    weights = {k: np.asarray(v)
               for k, v in flatten_dict(jtr.params, sep="/").items()}
    np.savez(tmp / "weights.npz", **weights)
    wait = spawn(tmp, WORKER, WORLD, tmp / "config.json", tmp / "weights.npz",
                 LR_STEPS, tmp / "out")
    jax_hist = jtr.train()  # meanwhile
    wait()
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return dict(raw=raw, ranks=ranks,
                jax={k: np.array([h[k] for h in jax_hist])
                     for k in ("loss", "grad_norm")})


def test_example_tracks_jax_per_step(runs):
    r0 = runs["ranks"][0]
    assert list(r0["unbroken/steps"]) == list(range(1, STEPS + 1))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(r0[f"unbroken/hist/{key}"],
                                   runs["jax"][key], **STEP_TOL, err_msg=key)
    for r in runs["ranks"][1:]:
        for f in r:
            if "/hist/" in f:
                np.testing.assert_array_equal(r0[f], r[f], err_msg=f)


def test_resume_equals_the_unbroken_run(runs):
    """On every rank: the resumed run's histories of steps 4-6 and its
    pieces (parameters, moments, count) equal the unbroken run's bit for
    bit. The pieces include FSDP's uneven ``Shard(0)``, the ep-cut experts
    and, in the dense ``with_tp`` case, ``_StridedShard``."""
    for r in runs["ranks"]:
        assert list(r["resumed/steps"]) == list(range(EVERY + 1, STEPS + 1))
        for key in ("loss", "grad_norm"):
            np.testing.assert_array_equal(r[f"resumed/hist/{key}"],
                                          r[f"unbroken/hist/{key}"][EVERY:])
        assert int(r["resumed/pieces"]) > 100
        assert list(r["resumed/unequal"]) == []
        assert list(r["dense/unequal"]) == []
        assert {"Shard", "_StridedShard", "Replicate"} <= set(r["kinds"])
    assert int(runs["ranks"][0]["example/count"]) == STEPS


def _restore_one_process(trainer, r0, tag, step):
    assert trainer._restore_state() == step
    assert trainer.checkpointer.reshard_restores == 1
    opt = trainer.optimizer
    names = trainer._optimizer_param_names()
    for n, p in trainer.module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      r0[f"{tag}/param/{n}"], err_msg=n)
    for n, m, v in zip(names, opt.mu, opt.nu):
        np.testing.assert_array_equal(m.numpy(), r0[f"{tag}/mu/{n}"])
        np.testing.assert_array_equal(v.numpy(), r0[f"{tag}/nu/{n}"])
    assert opt.count == step == trainer.stepper.step
    trainer.close()


def test_cross_mesh_restore_onto_one_process(runs):
    """The 8-rank checkpoints (the example's save_6 and the dense with_tp
    save_1) restored in this process, which has no process group, onto a
    one-process trainer: every parameter and moment is the 8 ranks'
    gathered value bit for bit."""
    raw = json.loads(json.dumps(runs["raw"]))
    raw["mesh"] = {}
    cfg = twin.parse_config(raw)
    trainer = twin.build_trainer(cfg, MeshParameters().build(["cpu"]),
                                 lr_total_steps=LR_STEPS)
    _restore_one_process(trainer, runs["ranks"][0], "example", STEPS)
    dense = Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(
            global_batch_size=4, microbatch_size=4, seq_len=16, total_steps=1,
            checkpoint_dir=raw["trainer"]["checkpoint_dir"] + "_dense"),
        model_provider=_Dense(), dataset_provider=None, task=CausalLMTask(),
        optimizer_provider=AdamWProvider(), learning_rate=1e-2)
    _restore_one_process(dense, runs["ranks"][0], "dense", 1)


class _Dense(ModelProvider):
    def build_module(self, ctx):
        return Qwen3DenseCausalLM(Qwen3DenseConfig.tiny(), dtype=torch.float32,
                                  device=ctx.device, seed=1)


def test_config_schema():
    cfg = twin.parse_config(SPEC)
    assert cfg.mesh.ep_shard == 4 and cfg.model.head_dim == 32
    assert cfg.trainer.checkpoint_every_steps == 20
    assert cfg.trainer.prefetch_batches == 2
    assert cfg.optimizer.b2 == 0.95 and cfg.optimizer.weight_decay == 0.01
    assert [p.mode for p in cfg.lr_scheduler.schedule.phases] == ["steps",
                                                                  "rest"]
    bad = json.loads(json.dumps(SPEC))
    bad["model"]["linear_attention_layers"] = [0]
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        twin.build_model_config(twin.parse_config(bad).model)
    bad = dict(SPEC, extra=1)
    with pytest.raises(ValueError, match="unknown fields"):
        twin.parse_config(bad)
    with pytest.raises(TypeError):
        twin.parse_config(dict(SPEC, trainer=dict(SPEC["trainer"], nope=1)))


WORKER_40 = r'''
import dataclasses
import json
import sys

import numpy as np
import torch

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.example.qwen3_moe import pretrain as twin
from d9d_tpu_torch.model_state.from_jax import load_jax_params

torch.set_num_threads(1)
rank, world, rdzv, cfg_path, weights_path, dst = sys.argv[1:7]
rank, world = int(rank), int(world)
cfg = twin.parse_config(json.load(open(cfg_path)))
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
data = np.load(weights_path)
ctx = MeshParameters(**dataclasses.asdict(cfg.mesh)).build(["cpu"] * world)
trainer = twin.build_trainer(cfg, ctx)
load_jax_params(trainer.module, {k: data[k] for k in data.files})
hist = trainer.train()
np.savez(f"{dst}{rank}.npz", **{k: np.array([h[k] for h in hist])
                                 for k in ("step", "loss", "grad_norm")})
assert "jax" not in sys.modules
shutdown_distributed()
'''


@pytest.mark.slow
def test_example_40_steps_track_jax(tmp_path):
    """ROADMAP A6's acceptance: all of pretrain.json's 40 steps (its own
    schedule, log_every 1, no checkpoint) against the JAX example, loss and
    grad norm per step within STEP_TOL."""
    raw = json.loads(json.dumps(SPEC))
    raw["trainer"].update(log_every=1, checkpoint_dir=None)
    raw["tracker"] = {"kind": "null"}
    raw["export_to"] = None
    (tmp_path / "config.json").write_text(json.dumps(raw))
    jtr = _jax_trainer(raw)
    np.savez(tmp_path / "weights.npz",
             **{k: np.asarray(v)
                for k, v in flatten_dict(jtr.params, sep="/").items()})
    wait = spawn(tmp_path, WORKER_40, WORLD, tmp_path / "config.json",
                 tmp_path / "weights.npz", tmp_path / "out", timeout=900)
    jax_hist = jtr.train()
    wait()
    got = dict(np.load(tmp_path / "out0.npz"))
    assert list(got["step"]) == list(range(1, LR_STEPS + 1))
    for key in ("loss", "grad_norm"):
        want = np.array([h[key] for h in jax_hist])
        print(key, "max rel diff",
              float(np.max(np.abs(got[key] - want) / np.abs(want))))
        np.testing.assert_allclose(got[key], want, **STEP_TOL, err_msg=key)
