"""Data-parallel training of the port: ``Trainer`` under ``hsdp_plan`` /
``fsdp_plan`` in gloo processes on the CPU vs the JAX ``Trainer`` on the
same mesh (4 of the suite's virtual CPU devices), and vs the port's own
one-process ``Trainer``.

Cases:

- (a) ``hsdp_plan`` at ``dp_replicate 2 x dp_shard 2``, 4 ranks, flash
  attention (plain versions on the CPU) against the JAX trainer with its
  eager attention;
- (b) ``fsdp_plan`` at ``dp_shard 2 x cp_shard 2``, 4 ranks, the ring
  backend on both sides (JAX's flash block in Pallas interpret mode);
- (c) ``fsdp_plan`` at ``dp_shard 2`` with bf16 parameters and
  ``StochasticAdamW``, 2 ranks, against the port's one-process bf16 run;
  both initialize from the same seed, so this case also holds the sharded
  init to the one-process build, bit for bit.

Config: ``tests/test_torch_cp_train.py``'s model (hidden 32, 2 layers, 4/2
heads of 8, vocab 32), seq 32, 4 steps, 2 microbatches of 4 rows (each
split over the dp ranks), a ``loss_mask`` and weight decay. In (a) and (b)
the JAX trainer initializes the weights and the port's ranks load them
into their pieces with ``load_jax_params``. Per-step loss and grad norm
within rtol 1e-4, final parameters (gathered) within rtol/atol 1e-3, the
tolerances of ``tests/test_torch_cp_train.py`` (sums in other orders,
carried from step to step by Adam's normalized update). Every rank's
history and gathered parameters are equal bit for bit (every rank applies
the same reduced sums); in (a) the two ``dp_r`` replicas' pieces are equal
bit for bit. Each rank's piece of every parameter has the shape of the
JAX array's shard on the device at the same mesh coordinate.

(c) follows ``tests/test_torch_train_bf16.py``'s rule: step 1 within rtol
1e-4, later steps within one bf16 ulp (2^-8) relative. The two runs round
with the same bits (B10's index offsets), so most parameter elements end bit
for bit equal (``BF16_EQUAL_SHARE`` says how many and why not all).
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
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.parallel import fsdp_plan as j_fsdp_plan
from d9d_tpu.parallel import hsdp_plan as j_hsdp_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
    StochasticAdamWConfig,
    Trainer,
    TrainerConfig,
    build_optimizer,
)
from d9d_tpu_torch.model_state.from_jax import jax_param_map, load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.logical_axes import param_layouts
from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
ROUNDED_STEP_TOL = dict(rtol=2.0 ** -8, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
# (c): the least share of each bf16 parameter's elements whose bits the
# sharded and the one-process runs agree on after 4 steps. The runs round
# with the same bits but from other fp32 values: each rank's gradient of its
# rows is bf16 (the cotangent has the parameter's dtype), the one-process
# run's of all rows, so the summed gradients differ by up to 2^-9 relative.
# Measured: 0.81-1.0 per parameter; with each piece rounded at its local
# indices instead 0.31-0.63.
BF16_EQUAL_SHARE = 0.75
VOCAB, STEPS, GBS, MBS, SEQ, LR, WD = 32, 4, 8, 4, 32, 1e-2, 0.1
MODEL = dict(vocab_ranges=(("default", VOCAB),), hidden_size=32, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=8, intermediate_size=64,
             remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=STEPS, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/tokens")


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
from d9d_tpu_torch.core.collectives import (allgather_variadic,
                                            host_allgather_object,
                                            host_allreduce,
                                            host_allreduce_tree,
                                            host_broadcast_object)
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, OptimizerProvider,
                                StochasticAdamWConfig, Trainer, TrainerConfig,
                                build_optimizer)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig, SdpaRingConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.ops.stochastic import stochastic_round_to_bf16
from d9d_tpu_torch.parallel import fsdp_plan, hsdp_plan
from d9d_tpu_torch.parallel.plan import ReducedGradients
from d9d_tpu_torch.parallel.shards import is_sharded, local_tensor

torch.set_num_threads(1)
rank, world, rdzv, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
spec = json.load(open(src + ".json"))
data = np.load(src + ".npz")
flat = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
batches = [{"input_ids": data[f"ids{i}"], "loss_mask": data[f"mask{i}"]}
           for i in range(spec["steps"])]
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
ctx = MeshParameters(**spec["mesh"]).build(["cpu"] * world)
param_dtype = getattr(torch, spec["param_dtype"])


class Model(ModelProvider):
    def build_module(self, ctx):
        cfg = dict(spec["model"])
        cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
        sdpa = build_sdpa_backend(SdpaRingConfig(head_axes=()), ctx=ctx) \
            if ctx.cp_size > 1 else build_sdpa_backend(SdpaFlashConfig())
        return Qwen3DenseCausalLM(
            Qwen3DenseConfig(**cfg), sdpa, dtype=torch.float32,
            param_dtype=param_dtype, device=ctx.device, seed=0)

    def build_plan(self, ctx):
        return {"fsdp": fsdp_plan, "hsdp": hsdp_plan}[spec["plan"]](ctx)


class Opt(OptimizerProvider):
    def build(self, params, learning_rate):
        return build_optimizer(StochasticAdamWConfig(weight_decay=spec["wd"]),
                               params, learning_rate)


class Data(DatasetProvider):
    def build(self):
        return iter(batches)


def full(p):
    p = p.detach()
    whole = p.full_tensor() if is_sharded(p) else p
    return whole.float().numpy().copy()


out = {}
# the mesh's coordinates and the host collectives over its groups
for name, axes in (("batch", ctx.batch_axes), ("fsdp", ctx.fsdp_axes),
                   ("cp", ("cp_s",)), ("all", ctx.grad_reduce_axes)):
    g = ctx.group(*axes)
    out[f"coord/{name}"] = np.int64(ctx.coordinate(*axes))
    out[f"sum/{name}"] = host_allreduce(np.array([rank, 1]), group=g)
    out[f"max/{name}"] = host_allreduce_tree(
        {"r": [np.array(rank)]}, op="max", group=g)["r"][0]
    out[f"objs/{name}"] = np.array(host_allgather_object(rank, group=g))
    out[f"bcast/{name}"] = np.int64(host_broadcast_object(
        rank if ctx.coordinate(*axes) == 0 else None, group=g))
    out[f"var/{name}"] = np.concatenate(allgather_variadic(
        np.full((rank + 1, 2), rank), group=g))
trainer = Trainer(
    ctx=ctx, config=TrainerConfig(**spec["train"]), model_provider=Model(),
    dataset_provider=Data(), task=CausalLMTask(),
    optimizer_provider=(Opt() if spec["stochastic"]
                        else AdamWProvider(weight_decay=spec["wd"])),
    learning_rate=spec["lr"])
for name, p in trainer.module.named_parameters():
    out[f"shape/{name}"] = np.array(local_tensor(p.detach()).shape)
    out[f"init/{name}"] = full(p)
if flat:
    load_jax_params(trainer.module, flat)
stochastic_round_to_bf16.plain_calls = 0
hist = trainer.train()
for key in spec["keys"]:
    out[f"hist/{key}"] = np.array([h[key] for h in hist])
for name, p in trainer.module.named_parameters():
    out[f"full/{name}"] = full(p)
    out[f"local/{name}"] = local_tensor(p.detach()).float().numpy()
out["rounded"] = np.int64(stochastic_round_to_bf16.plain_calls)
out["eval_loss"] = np.float64(trainer.loss_on_batch(batches[0]))
if spec["stochastic"]:
    # one more backward: the kept fp32 gradients against FSDP's bf16 ones
    reduced = ReducedGradients(trainer.module)
    for p in trainer.module.parameters():
        p.grad = None
    trainer.module.set_requires_gradient_sync(True)
    mb = trainer._stage_batch(batches[0])[0]
    CausalLMTask().loss_fn(trainer.module, mb)[0].backward()
    kept = reduced.take()
    assert all(torch.equal(g.to(torch.bfloat16), local_tensor(p.grad))
               for p, g in kept.items())
    out["reduced_fp32"] = np.int64(len(kept))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


class _JModel(JModelProvider):
    def __init__(self, sdpa, plan):
        self.sdpa, self.plan = sdpa, plan

    def build_module(self, stage):
        return JQwen3DenseCausalLM(config=JQwen3DenseConfig(**MODEL),
                                   sdpa=self.sdpa, stage=stage,
                                   dtype=jnp.float32)

    def build_plan(self, ctx):
        return self.plan(ctx)

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
    def __init__(self, flat=None, param_dtype=torch.float32):
        self.flat, self.param_dtype = flat, param_dtype

    def build_module(self, ctx):
        model = Qwen3DenseCausalLM(
            Qwen3DenseConfig(**MODEL), build_sdpa_backend(SdpaFlashConfig()),
            dtype=torch.float32, param_dtype=self.param_dtype,
            device=ctx.device, seed=0)
        if self.flat is not None:
            load_jax_params(model, self.flat)
        return model


class _TOpt(OptimizerProvider):
    def build(self, params, learning_rate):
        return build_optimizer(StochasticAdamWConfig(weight_decay=WD), params,
                               learning_rate)


def _jax_trainer(batches, mesh, plan, sdpa):
    ctx = JMeshParameters(**mesh).build(jax.devices()[:4])
    return JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(sdpa, plan), dataset_provider=_JData(batches),
        task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)


def _start(tmp_path, world, batches, flat, **spec):
    src = tmp_path / "run"
    arrays = {f"w/{k}": v for k, v in (flat or {}).items()}
    for i, b in enumerate(batches):
        arrays[f"ids{i}"], arrays[f"mask{i}"] = b["input_ids"], b["loss_mask"]
    np.savez(f"{src}.npz", **arrays)
    (tmp_path / "run.json").write_text(json.dumps(dict(
        model=MODEL, train=TRAIN, steps=STEPS, lr=LR, wd=WD, keys=KEYS,
        **spec)))
    wait = spawn(tmp_path, WORKER, world, src, tmp_path / "out")

    def ranks():
        wait()
        return [np.load(tmp_path / f"out{r}.npz") for r in range(world)]

    return ranks


def _one_process(batches, flat=None, param_dtype=torch.float32):
    stochastic = param_dtype == torch.bfloat16
    trainer = Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(**TRAIN),
        model_provider=_TModel(flat, param_dtype),
        dataset_provider=_TData(batches), task=CausalLMTask(),
        optimizer_provider=(_TOpt() if stochastic
                            else AdamWProvider(weight_decay=WD)),
        learning_rate=LR)
    return trainer


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _check_mesh_groups(ranks, sizes):
    """Each rank's coordinate on the batch, fsdp, cp and gradient-reduce
    axes (row-major over ``sizes`` = (dp_r, dp_s, cp_s)), and the host
    collectives over those groups: sums, maxima, gathered objects and
    variadic arrays in group order, the group's first rank's broadcast."""
    dp_r, dp_s, cp_s = sizes
    axes = {"batch": (0, 1), "fsdp": (1, 2), "cp": (2,), "all": (0, 1, 2)}
    coords = [np.unravel_index(r, sizes) for r in range(len(ranks))]
    for name, dims in axes.items():
        for r, out in enumerate(ranks):
            members = [q for q in range(len(ranks))
                       if all(coords[q][d] == coords[r][d]
                              for d in range(3) if d not in dims)]
            flat = np.ravel_multi_index(
                [coords[r][d] for d in dims], [sizes[d] for d in dims])
            assert int(out[f"coord/{name}"]) == flat, (name, r)
            np.testing.assert_array_equal(out[f"sum/{name}"],
                                          [sum(members), len(members)])
            assert int(out[f"max/{name}"]) == max(members)
            np.testing.assert_array_equal(out[f"objs/{name}"], members)
            assert int(out[f"bcast/{name}"]) == members[0]
            np.testing.assert_array_equal(out[f"var/{name}"], np.concatenate(
                [np.full((q + 1, 2), q) for q in members]))


def _check_ranks_equal(ranks):
    r0 = ranks[0]
    for r in ranks[1:]:
        for f in r0.files:
            if f.startswith(("hist/", "full/", "eval_loss")):
                np.testing.assert_array_equal(r0[f], r[f], err_msg=f)


def _check_shard_shapes(ranks, jtr, flat):
    """Each rank's piece of every parameter has the shape of the JAX
    array's shard on the device at the same mesh coordinate."""
    model = Qwen3DenseCausalLM(Qwen3DenseConfig(**MODEL), dtype=torch.float32,
                               device="cpu", seed=None)
    layouts = param_layouts(model)
    devices = list(jtr.ctx.mesh.devices.flat)
    leaves = {k[len("params/"):]: v
              for k, v in flatten_dict(jtr.params, sep="/").items()}
    sharded = 0
    for name, (key,) in jax_param_map(model, flat).items():
        shards = {s.device: s.data.shape for s in leaves[key].addressable_shards}
        for r, out in enumerate(ranks):
            want = shards[devices[r]]
            if layouts[name].transposed:
                want = want[::-1]
            assert tuple(out[f"shape/{name}"]) == tuple(want), (name, r)
        sharded += shards[devices[0]] != leaves[key].shape
    assert sharded > 0


def _check_against(got_ranks, jh, th, jtr, ttr):
    r0 = got_ranks[0]
    for key in KEYS:
        got = r0[f"hist/{key}"]
        np.testing.assert_allclose(got, [h[key] for h in jh], **STEP_TOL,
                                   err_msg=f"vs JAX: {key}")
        np.testing.assert_allclose(got, [h[key] for h in th], **STEP_TOL,
                                   err_msg=f"vs one process: {key}")
    assert all(w < GBS * SEQ for w in r0["hist/loss_weight"])
    want = Qwen3DenseCausalLM(Qwen3DenseConfig(**MODEL), dtype=torch.float32,
                              device="cpu", seed=None)
    load_jax_params(want, _flat(jtr.params))
    one = dict(ttr.module.named_parameters())
    for name, w in want.named_parameters():
        got = r0[f"full/{name}"]
        np.testing.assert_allclose(got, w.detach().numpy(), **PARAM_TOL,
                                   err_msg=f"vs JAX: {name}")
        np.testing.assert_allclose(got, one[name].detach().numpy(),
                                   **PARAM_TOL, err_msg=f"vs one process: {name}")
    assert float(r0["eval_loss"]) == pytest.approx(
        ttr.loss_on_batch(_batches()[0]), rel=1e-4)


def test_hsdp_trainer_matches_jax_and_one_process(tmp_path):
    """(a) hsdp_plan at dp_replicate 2 x dp_shard 2."""
    batches = _batches()
    mesh = dict(dp_replicate=2, dp_shard=2)
    jtr = _jax_trainer(batches, mesh, j_hsdp_plan, j_eager_sdpa)
    flat = _flat(jtr.params)
    ranks = _start(tmp_path, 4, batches, flat, mesh=mesh, plan="hsdp",
                   param_dtype="float32", stochastic=False)
    jh = jtr.train()  # meanwhile: the JAX run, then the port on one process
    ttr = _one_process(batches, flat)
    th = ttr.train()
    ranks = ranks()
    _check_mesh_groups(ranks, (2, 2, 1))
    _check_ranks_equal(ranks)
    _check_shard_shapes(ranks, jtr, flat)
    # rank = 2 dp_r + dp_s: the dp_r replicas of each piece are equal
    for name in (f[len("local/"):] for f in ranks[0].files
                 if f.startswith("local/")):
        for s in range(2):
            np.testing.assert_array_equal(ranks[s][f"local/{name}"],
                                          ranks[2 + s][f"local/{name}"],
                                          err_msg=name)
    assert not np.array_equal(ranks[0]["local/lm_head.weight"],
                              ranks[1]["local/lm_head.weight"])
    _check_against(ranks, jh, th, jtr, ttr)


def test_fsdp_dp_cp_trainer_matches_jax_and_one_process(tmp_path):
    """(b) fsdp_plan at dp_shard 2 x cp_shard 2, ring attention."""
    batches = _batches()
    mesh = dict(dp_shard=2, cp_shard=2)
    ring = j_build_sdpa_backend(JSdpaRingConfig(
        seq_axis="cp_s", batch_axes=("dp_r", "dp_s"), head_axes=()))
    jtr = _jax_trainer(batches, mesh, j_fsdp_plan, ring)
    flat = _flat(jtr.params)
    ranks = _start(tmp_path, 4, batches, flat, mesh=mesh, plan="fsdp",
                   param_dtype="float32", stochastic=False)
    jh = jtr.train()
    ttr = _one_process(batches, flat)
    th = ttr.train()
    ranks = ranks()
    _check_mesh_groups(ranks, (1, 2, 2))
    _check_ranks_equal(ranks)
    _check_shard_shapes(ranks, jtr, flat)
    _check_against(ranks, jh, th, jtr, ttr)


def test_fsdp_bf16_stochastic_adamw_matches_one_process(tmp_path):
    """(c) fsdp_plan at dp_shard 2, bf16 parameters, StochasticAdamW; the
    sharded init against the one-process build."""
    batches = _batches()
    ranks = _start(tmp_path, 2, batches, None, mesh=dict(dp_shard=2),
                   plan="fsdp", param_dtype="bfloat16", stochastic=True)
    ttr = _one_process(batches, param_dtype=torch.bfloat16)
    init = {n: p.detach().float().numpy().copy()
            for n, p in ttr.module.named_parameters()}
    th = ttr.train()
    ranks = ranks()
    _check_ranks_equal(ranks)
    r0 = ranks[0]
    for name, want in init.items():  # the sharded init, gathered
        np.testing.assert_array_equal(r0[f"init/{name}"], want, err_msg=name)
    for key in ("loss", "grad_norm"):
        got, want = r0[f"hist/{key}"], [h[key] for h in th]
        np.testing.assert_allclose(got[:1], want[:1], **STEP_TOL, err_msg=key)
        np.testing.assert_allclose(got, want, **ROUNDED_STEP_TOL, err_msg=key)
    for name, p in ttr.module.named_parameters():
        got, want = r0[f"full/{name}"], p.detach().float().numpy()
        if p.dtype == torch.bfloat16:
            assert (got == want).mean() >= BF16_EQUAL_SHARE, name
        else:  # the fp32 layer norms: sums in other orders
            np.testing.assert_allclose(got, want, **PARAM_TOL, err_msg=name)
    # the fp32 gradients kept for the sharded bf16 parameters are FSDP's own
    # (cast to bf16, they are its gradients bit for bit), one per piece
    assert [int(r["reduced_fp32"]) for r in ranks] == [16] * 2
    # one rounding per bf16 parameter piece and step (fp32 moments)
    n_bf16 = sum(p.dtype == torch.bfloat16
                 for p in ttr.module.parameters())
    assert [int(r["rounded"]) for r in ranks] == [n_bf16 * STEPS] * 2
