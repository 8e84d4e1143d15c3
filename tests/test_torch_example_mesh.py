"""The example's own mesh in the port: ``example/qwen3_moe/pretrain.json``'s
``dp_replicate 2 x dp_shard 2 x tp 2, ep_shard 4`` (ep over ``(dp_s, tp)``,
``dup`` = tp, ep replicated over ``dp_r``) and the reference dryrun's leg 1,
``dp_replicate 2 x cp_shard 2 x tp 2, ep_shard 4`` (ep over ``(cp_s, tp)``)
with the ring over each rank's head slice and ``fsdp_ep_plan(with_tp=
True)``: ``Trainer`` in 8 gloo processes on the CPU against the JAX
``Trainer`` on the same mesh of the suite's 8 virtual CPU devices, both
from the JAX trainer's initial weights (``load_jax_params``), one step.

Cases:

- ``pretrain_token``: the example's mesh and plan (``fsdp_ep_plan``), the
  token-layout flow;
- ``pretrain_legacy``: the same in the legacy flow (``token_axes=None``):
  JAX flattens the global batch and cuts it over the ep axes, every
  ``dp_r`` replica computing every piece, so each rank's piece is another
  rank's rows (``nn/moe.py`` ``LegacyPieces``);
- ``leg1_legacy_drop``: the dryrun's leg-1 mesh in the legacy flow under
  ``ep_capacity_factor`` ``CAPACITY``, low enough that pairs drop. The
  legacy flow's pieces compete for room in JAX's grouping, so its drops
  are not the token flow's: the port's token-flow run of the same mesh
  and capacity (``leg1_token_drop``, not run in JAX) ends with parameters
  that differ from the legacy run's by far more than the tolerance.

Tolerances are ``tests/test_torch_ep.py``'s: loss and grad norm within
rtol 1e-4, every gathered parameter within rtol/atol 1e-3. The 8 ranks'
histories and parameters are equal bit for bit.
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
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.ops.attention.ring import make_ring_sdpa as j_make_ring_sdpa
from d9d_tpu.parallel import fsdp_ep_plan as j_fsdp_ep_plan
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
VOCAB, GBS, MBS, SEQ, LR, WD = 256, 8, 4, 32, 1e-2, 0.1
WORLD = 8
CAPACITY = 0.5
# Qwen3MoeConfig.tiny()'s widths at 1 of its 2 layers
MODEL = dict(vocab_ranges=(("default", VOCAB),), hidden_size=64, num_layers=1,
             num_heads=4, num_kv_heads=2, head_dim=16,
             moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
             remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=1, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/moe_load_max_frac")
PRETRAIN = dict(dp_replicate=2, dp_shard=2, tp=2, ep_shard=4)
LEG1 = dict(dp_replicate=2, cp_shard=2, tp=2, ep_shard=4)
# name: mesh, with_tp, ring head axes (None: local attention), legacy flow,
# capacity factor
CASES = {
    "pretrain_token": (PRETRAIN, False, None, False, None),
    "pretrain_legacy": (PRETRAIN, False, None, True, None),
    "leg1_legacy_drop": (LEG1, True, ["tp"], True, CAPACITY),
    "leg1_token_drop": (LEG1, True, ["tp"], False, CAPACITY),
}
JAX_CASES = tuple(CASES)[:3]


def _batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, VOCAB, (GBS, SEQ + 1)),
             "loss_mask": (rng.random((GBS, SEQ + 1)) > 0.3).astype(np.int32)}]


WORKER = r'''
import dataclasses
import json
import sys

import numpy as np
import torch

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.core import collectives
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, Trainer, TrainerConfig)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn.sdpa import SdpaRingConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.ops import ep_dispatch
from d9d_tpu_torch.parallel import fsdp_ep_plan
from d9d_tpu_torch.parallel.shards import is_sharded

torch.set_num_threads(1)
rank, world, rdzv, spec_path, data_path, dst = sys.argv[1:7]
rank, world = int(rank), int(world)
spec = json.load(open(spec_path))
data = np.load(data_path)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
batches = [{"input_ids": data["ids"], "loss_mask": data["mask"]}]
flat = {k[2:]: data[k] for k in data.files if k.startswith("w/")}


def full(p):
    p = p.detach()
    whole = p.full_tensor() if is_sharded(p) else p
    return whole.float().numpy().copy()


def train(name, mesh, with_tp, ring, legacy, capacity):
    ctx = MeshParameters(**mesh).build(["cpu"] * world)

    class Model(ModelProvider):
        def build_module(self, c):
            cfg = dict(spec["model"])
            cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
            cfg = Qwen3MoeConfig(
                **cfg, ep_axes=c.ep_shard_axes, ep_capacity_factor=capacity,
                moe_token_axes=None if legacy else (c.batch_axes,
                                                    c.sequence_axes))
            sdpa = (build_sdpa_backend(SdpaRingConfig(head_axes=tuple(ring)),
                                       ctx=c) if ring is not None else None)
            return Qwen3MoeCausalLM(cfg, sdpa, dtype=torch.float32,
                                    device=c.device, seed=0)

        def build_plan(self, c):
            return fsdp_ep_plan(c, with_tp=with_tp)

    class Data(DatasetProvider):
        def build(self):
            return iter(batches)

    trainer = Trainer(
        ctx=ctx, config=TrainerConfig(**spec["train"]),
        model_provider=Model(), dataset_provider=Data(), task=CausalLMTask(),
        optimizer_provider=AdamWProvider(weight_decay=spec["wd"]),
        learning_rate=spec["lr"])
    load_jax_params(trainer.module, flat)
    ep_dispatch.reset_counters()
    hist = trainer.train()
    f = ep_dispatch.ep_dispatch_compute_combine
    out = {"dropped": np.int64(f.dropped_pairs),
           "a2a_calls": np.int64(collectives.all_to_all_rows.calls)}
    for key in spec["keys"]:
        out[f"hist/{key}"] = np.array([h[key] for h in hist])
    for pname, p in trainer.module.named_parameters():
        out[f"full/{pname}"] = full(p)
    return {f"{name}/{k}": v for k, v in out.items()}


out = {}
for name, case in spec["cases"].items():
    out.update(train(name, **case))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


class _JModel(JModelProvider):
    def __init__(self, ctx, name):
        self.ctx, self.case = ctx, CASES[name]

    def build_module(self, stage):
        ctx = self.ctx
        _, _, ring, legacy, capacity = self.case
        cfg = JQwen3MoeConfig(
            **MODEL, ep_axes=ctx.ep_shard_axes, ep_capacity_factor=capacity,
            moe_token_axes=None if legacy else (ctx.batch_axes,
                                                ctx.sequence_axes))
        sdpa = (j_eager_sdpa if ring is None else j_make_ring_sdpa(
            ctx.mesh, head_axes=tuple(ring), impl="eager"))
        return JQwen3MoeCausalLM(config=cfg, sdpa=sdpa, stage=stage,
                                 dtype=jnp.float32)

    def build_plan(self, ctx):
        return j_fsdp_ep_plan(ctx, with_tp=self.case[1])

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _JData(JDatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


def _flat(tree):
    return {k[len("params/"):]: np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def _build_jax(name, batches):
    ctx = JMeshParameters(**CASES[name][0]).build(jax.devices()[:WORLD])
    return JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(ctx, name), dataset_provider=_JData(batches),
        task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example_mesh")
    batches = _batches()
    first = _build_jax("pretrain_token", batches)
    weights = _flat(first.params)
    np.savez(tmp / "run.npz", ids=batches[0]["input_ids"],
             mask=batches[0]["loss_mask"],
             **{f"w/{k}": v for k, v in weights.items()})
    cases = {n: dict(mesh=c[0], with_tp=c[1], ring=c[2], legacy=c[3],
                     capacity=c[4]) for n, c in CASES.items()}
    (tmp / "spec.json").write_text(json.dumps(dict(
        lr=LR, wd=WD, keys=KEYS, cases=cases, train=TRAIN,
        model=dict(MODEL, vocab_ranges=[list(r) for r in
                                        MODEL["vocab_ranges"]]))))
    wait = spawn(tmp, WORKER, WORLD, tmp / "spec.json", tmp / "run.npz",
                 tmp / "out")
    jax_out = {}
    for name in JAX_CASES:  # meanwhile: JAX's trainers, one after the other
        jtr = first if name == "pretrain_token" else _build_jax(name, batches)
        for key, value in weights.items():
            np.testing.assert_array_equal(_flat(jtr.params)[key], value,
                                          err_msg=f"{name} init: {key}")
        hist = jtr.train()
        jax_out[name] = ({k: np.array([h[k] for h in hist]) for k in KEYS},
                         _flat(jtr.params))
        del jtr
    first = None
    wait()
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return dict(ranks=ranks, jax=jax_out)


@pytest.mark.parametrize("name", JAX_CASES)
def test_example_mesh_matches_jax(runs, name):
    """Loss, grad norm, token weight and load fraction, and every gathered
    parameter, against JAX's Trainer on the same mesh; the 8 ranks agree
    bit for bit."""
    ranks = runs["ranks"]
    jax_hist, jax_params = runs["jax"][name]
    r0 = ranks[0]
    for r in ranks[1:]:
        for f in r0:
            if f.startswith((f"{name}/hist/", f"{name}/full/")):
                np.testing.assert_array_equal(r0[f], r[f], err_msg=f)
    for key in KEYS[:3]:
        np.testing.assert_allclose(r0[f"{name}/hist/{key}"], jax_hist[key],
                                   **STEP_TOL, err_msg=f"{name}: {key}")
    np.testing.assert_array_equal(r0[f"{name}/hist/task/moe_load_max_frac"],
                                  jax_hist["task/moe_load_max_frac"])
    want = Qwen3MoeCausalLM(Qwen3MoeConfig(**MODEL), dtype=torch.float32,
                            device="cpu", seed=None)
    load_jax_params(want, jax_params)
    for pname, w in want.named_parameters():
        np.testing.assert_allclose(r0[f"{name}/full/{pname}"],
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=f"{name} vs JAX: {pname}")


def test_legacy_drops_are_not_the_token_flows(runs):
    """Under the capacity both flows drop pairs, but not the same ones: a
    pair dropped in one flow and kept in the other moves its expert's
    weights by Adam's step in one run only, so the two runs' parameters
    lie far outside the tolerance of each other, while the legacy run is
    within it of JAX's (``test_example_mesh_matches_jax``). Without a
    capacity nothing drops."""
    ranks = runs["ranks"]
    dropped = {n: sum(int(r[f"{n}/dropped"]) for r in ranks) for n in CASES}
    assert dropped["pretrain_token"] == dropped["pretrain_legacy"] == 0
    assert dropped["leg1_legacy_drop"] > 0 and dropped["leg1_token_drop"] > 0
    r0 = ranks[0]
    worst = 0.0
    for f in r0:
        if f.startswith("leg1_legacy_drop/full/"):
            a, b = r0[f], r0[f.replace("legacy", "token", 1)]
            worst = max(worst, float(np.max(np.abs(a - b) / (
                PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(b)))))
    assert worst > 2.0, worst
