"""Expert parallelism in the port: the all-to-all dispatch and ``Trainer``
under ``fsdp_ep_plan`` in gloo processes on the CPU, against the JAX
package on the same mesh of the suite's virtual CPU devices.

(i) The dispatch (``ops/ep_dispatch.py`` with the layer's expert compute,
``nn/moe.py`` ``expert_ffn``) against ``ep_dispatch_compute_combine``
under ``shard_map`` (its expert function the SwiGLU experts with probs 1,
as ``MoELayer._forward_ep`` builds it), at W = 2 and 4: dropless, a
capacity that drops nothing, and capacity 1.0, which drops. Output and
gradients with respect to x, probs and the expert weights within rtol/atol
1e-5 (fp32); a dropped pair's result is exactly zero, so its prob's
gradient is exactly zero, on the same pairs on both sides.

(ii) ``Trainer`` on ``Qwen3MoeConfig.tiny()`` widths at 1 layer under
``fsdp_ep_plan`` with the token-layout flow against JAX's ``Trainer`` on
the same mesh, both from the JAX trainer's initial weights
(``load_jax_params``):

- ``dp_ep``: ``dp_shard 2, ep_shard 2`` (ep over ``dp_s``);
- ``dp_tp_ep``: ``dp_shard 2 x tp 2, ep_shard 4``, ``with_tp=True``: ep
  over ``(dp_s, tp)``, the tp ranks each taking half of their block
  (``dup = 2``), JAX's ``test_ep_token_layout_matches_local`` mesh shape;
- ``dp_r_cp_ep``: ``dp_replicate 2 x cp_shard 2, ep_shard 2``: ep over
  ``cp_s`` beside the ring, the expert gradients summed over ``dp_r``.

Tolerances are ``tests/test_torch_dp_train.py``'s: loss and grad norm per
step within rtol 1e-4, gathered final parameters within rtol/atol 1e-3;
``task/moe_load_max_frac`` equal. Each rank's expert piece has the shape
and initial values of the JAX shard at its mesh coordinate, and its final
values within the parameter tolerance; the sharded init, gathered, is the
one-process build bit for bit.

(iii) Local experts on a dp mesh: ``dp_shard 2`` under ``fsdp_plan``
(``ep_axes=None``) against the port's one-process ``Trainer``; and the
legacy flow (``token_axes=None``) at ``dp_shard 2, ep_shard 2``, where
JAX's pieces are the ranks' own blocks (no exchange), against the
token-layout flow; the legacy flow elsewhere is
``tests/test_torch_example_mesh.py``'s.

One step a run: JAX's trainer compiles its step twice (its first step
takes a replicated optimizer state, the second a sharded one), and its
compiles bound the file's time.

The 4-rank cases and W = 4 run in one spawn of 4 processes, the others in
one of 2; the JAX side runs in this process meanwhile.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh, PartitionSpec as P

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.core import compat
from d9d_tpu.loop import AdamWProvider as JAdamWProvider
from d9d_tpu.loop import CausalLMTask as JCausalLMTask
from d9d_tpu.loop import DatasetProvider as JDatasetProvider
from d9d_tpu.loop import ModelProvider as JModelProvider
from d9d_tpu.loop import Trainer as JTrainer
from d9d_tpu.loop import TrainerConfig as JTrainerConfig
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.nn.moe import grouped_swiglu_apply as j_grouped_swiglu_apply
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.ops.attention.ring import make_ring_sdpa as j_make_ring_sdpa
from d9d_tpu.ops.ep_dispatch import (
    ep_dispatch_compute_combine as j_ep_dispatch,
)
from d9d_tpu.parallel import fsdp_ep_plan as j_fsdp_ep_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    Trainer,
    TrainerConfig,
)
from d9d_tpu_torch.model_state.from_jax import jax_param_map, load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
DISPATCH_TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, STEPS, GBS, MBS, SEQ, LR, WD = 256, 1, 8, 4, 32, 1e-2, 0.1
# Qwen3MoeConfig.tiny()'s widths at 1 of its 2 layers
MODEL = dict(vocab_ranges=(("default", VOCAB),), hidden_size=64, num_layers=1,
             num_heads=4, num_kv_heads=2, head_dim=16,
             moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
             remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=STEPS, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/moe_load_max_frac")
# name: (mesh, plan, ring head axes or None)
CASES = {
    "dp_ep": (dict(dp_shard=2, ep_shard=2), "fsdp_ep", None),
    "dp_tp_ep": (dict(dp_shard=2, tp=2, ep_shard=4), "fsdp_ep_tp", None),
    "dp_r_cp_ep": (dict(dp_replicate=2, cp_shard=2, ep_shard=2), "fsdp_ep",
                   []),
    "dp_local": (dict(dp_shard=2), "fsdp", None),
    # token_axes=None: JAX's reshard gives each rank its own block here
    "dp_ep_legacy": (dict(dp_shard=2, ep_shard=2), "fsdp_ep_legacy", None),
}
JAX_CASES = ("dp_ep", "dp_tp_ep", "dp_r_cp_ep")
# dispatch: experts, tokens a rank, top-k, width, expert width
DE, DN, DK, DD, DI = 8, 12, 2, 16, 32
# capacity: None (dropless), 4.0 (room for every row: drops nothing), 1.0
CAPACITIES = {"dropless": None, "generous": 4.0, "tight": 1.0}
DISPATCH = [(w, c) for w in (2, 4) for c in CAPACITIES]


def _world(mesh):
    return int(np.prod([v for k, v in mesh.items() if k != "ep_shard"]))


def _batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, VOCAB, (GBS, SEQ + 1)),
             "loss_mask": (rng.random((GBS, SEQ + 1)) > 0.3).astype(np.int32)}
            for _ in range(STEPS)]


def _dispatch_inputs(w):
    """x, ids (distinct experts a token, skewed towards the low experts so
    that capacity 1.0 overflows), probs, cotangent, expert weights."""
    rng = np.random.default_rng(10 + w)
    n = w * DN
    first = rng.choice(DE, n, p=np.linspace(2.0, 0.5, DE) / np.linspace(
        2.0, 0.5, DE).sum())
    ids = np.stack([first, (first + 1 + rng.integers(0, DE - 1, n)) % DE], 1)
    return dict(
        x=rng.standard_normal((n, DD)).astype(np.float32),
        ids=ids.astype(np.int32),
        probs=rng.random((n, DK)).astype(np.float32),
        cot=rng.standard_normal((n, DD)).astype(np.float32),
        gate=(0.3 * rng.standard_normal((DE, DD, DI))).astype(np.float32),
        up=(0.3 * rng.standard_normal((DE, DD, DI))).astype(np.float32),
        down=(0.3 * rng.standard_normal((DE, DI, DD))).astype(np.float32))


def _jax_dispatch(w):
    """JAX's dispatch under ``shard_map`` over W devices, at every capacity
    (one compile): output and the gradients of ``sum(out * cot)``."""
    d = _dispatch_inputs(w)
    mesh = Mesh(np.array(jax.devices()[:w]), ("ep",))
    e_loc = DE // w

    def body(capacity, x, ids, probs, gate, up, down):
        def expert_fn(rows, group_sizes):
            return j_grouped_swiglu_apply(
                rows, jnp.ones((rows.shape[0],), jnp.float32), group_sizes,
                gate, up, down, jnp.float32)

        return j_ep_dispatch(x, ids, probs, expert_fn, ep_axes=("ep",),
                             e_loc=e_loc, ep_world=w,
                             capacity_factor=capacity)

    def loss(capacity, x, probs, gate, up, down):
        out = compat.shard_map(
            lambda *a: body(CAPACITIES[capacity], *a), mesh=mesh,
            in_specs=(P("ep"),) * 6, out_specs=P("ep"), check_vma=False)(
                x, jnp.asarray(d["ids"]), probs, gate, up, down)
        return (out * d["cot"]).sum(), out

    @jax.jit
    def run(*args):
        return {c: jax.grad(functools.partial(loss, c), argnums=range(5),
                            has_aux=True)(*args) for c in CAPACITIES}

    with jax.set_mesh(mesh):
        got = run(d["x"], d["probs"], d["gate"], d["up"], d["down"])
    names = ("dx", "dprobs", "dgate", "dup", "ddown")
    res = {}
    for c, (grads, out) in got.items():
        res[c] = {n: np.asarray(g) for n, g in zip(names, grads)}
        res[c]["out"] = np.asarray(out)
    return res


WORKER = r'''
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.core import collectives
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, Trainer, TrainerConfig)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn.moe import expert_ffn
from d9d_tpu_torch.nn.sdpa import SdpaRingConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.ops import ep_dispatch
from d9d_tpu_torch.parallel import fsdp_ep_plan, fsdp_plan
from d9d_tpu_torch.parallel.shards import is_sharded, local_tensor

torch.set_num_threads(1)
rank, world, rdzv, spec_path, data_path, dst = sys.argv[1:7]
rank, world = int(rank), int(world)
spec = json.load(open(spec_path))
data = np.load(data_path)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
PLANS = {"fsdp": fsdp_plan, "fsdp_ep": fsdp_ep_plan,
         "fsdp_ep_legacy": fsdp_ep_plan,
         "fsdp_ep_tp": lambda c: fsdp_ep_plan(c, with_tp=True)}
batches = [{"input_ids": data[f"ids{i}"], "loss_mask": data[f"mask{i}"]}
           for i in range(spec["train"]["total_steps"])]
flat = {k[2:]: data[k] for k in data.files if k.startswith("w/")}


def full(p):
    p = p.detach()
    whole = p.full_tensor() if is_sharded(p) else p
    return whole.float().numpy().copy()


def dispatch(w, capacity):
    tag = f"d{w}"
    n = data[f"{tag}/x"].shape[0] // world
    e_loc = spec["experts"] // world
    rows = slice(rank * n, (rank + 1) * n)
    x = torch.from_numpy(data[f"{tag}/x"][rows]).requires_grad_()
    probs = torch.from_numpy(data[f"{tag}/probs"][rows]).requires_grad_()
    ids = torch.from_numpy(data[f"{tag}/ids"][rows]).long()
    ws = [torch.from_numpy(data[f"{tag}/{k}"][rank * e_loc:(rank + 1) * e_loc]
                           ).requires_grad_() for k in ("gate", "up", "down")]
    ep_dispatch.reset_counters()
    out = ep_dispatch.ep_dispatch_compute_combine(
        x, ids, probs, expert_ffn(ws, torch.float32), group=dist.group.WORLD,
        ep_rank=rank, e_loc=e_loc,
        capacity_factor=spec["capacities"][capacity])
    (out * torch.from_numpy(data[f"{tag}/cot"][rows])).sum().backward()
    f = ep_dispatch.ep_dispatch_compute_combine
    res = dict(out=out.detach().numpy(), dx=x.grad.numpy(),
               dprobs=probs.grad.numpy(), dropped=np.int64(f.dropped_pairs),
               readbacks=np.int64(collectives.allgather_counts.readbacks),
               a2a_calls=np.int64(collectives.all_to_all_rows.calls))
    for k, wt in zip(("dgate", "dup", "ddown"), ws):
        res[k] = wt.grad.numpy()
    return {f"{tag}_{capacity}/{k}": v for k, v in res.items()}


def train(name, mesh, plan, ring):
    ctx = MeshParameters(**mesh).build(["cpu"] * world)
    ep = plan.startswith("fsdp_ep")

    class Model(ModelProvider):
        def build_module(self, c):
            cfg = dict(spec["model"])
            cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
            cfg = Qwen3MoeConfig(**cfg)
            if ep:
                cfg = dataclasses.replace(
                    cfg, ep_axes=c.ep_shard_axes,
                    moe_token_axes=None if plan.endswith("legacy") else (
                        c.batch_axes, c.sequence_axes))
            sdpa = (build_sdpa_backend(SdpaRingConfig(head_axes=tuple(ring)),
                                       ctx=c) if ring is not None else None)
            return Qwen3MoeCausalLM(cfg, sdpa, dtype=torch.float32,
                                    device=c.device, seed=0)

        def build_plan(self, c):
            return PLANS[plan](c)

    class Data(DatasetProvider):
        def build(self):
            return iter(batches)

    trainer = Trainer(
        ctx=ctx, config=TrainerConfig(**spec["train"]),
        model_provider=Model(), dataset_provider=Data(), task=CausalLMTask(),
        optimizer_provider=AdamWProvider(weight_decay=spec["wd"]),
        learning_rate=spec["lr"])
    out = {}
    for pname, p in trainer.module.named_parameters():
        out[f"shape/{pname}"] = np.array(local_tensor(p.detach()).shape)
        out[f"init/{pname}"] = full(p)
    load_jax_params(trainer.module, flat)
    for pname, p in trainer.module.named_parameters():
        if "grouped_experts" in pname:
            out[f"piece0/{pname}"] = local_tensor(p.detach()).numpy().copy()
    hist = trainer.train()
    for key in spec["keys"]:
        out[f"hist/{key}"] = np.array([h[key] for h in hist])
    for pname, p in trainer.module.named_parameters():
        out[f"full/{pname}"] = full(p)
        if "grouped_experts" in pname:
            out[f"piece/{pname}"] = local_tensor(p.detach()).numpy().copy()
    out["ep_rank"] = np.int64(ctx.ep_rank)
    return {f"{name}/{k}": v for k, v in out.items()}


out = {}
for w, capacity in spec["dispatch"]:
    out.update(dispatch(w, capacity))
for name, case in spec["cases"].items():
    out.update(train(name, **case))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''


class _JModel(JModelProvider):
    def __init__(self, ctx, ring, with_tp):
        self.ctx, self.ring, self.with_tp = ctx, ring, with_tp

    def build_module(self, stage):
        ctx = self.ctx
        cfg = JQwen3MoeConfig(
            **MODEL, ep_axes=ctx.ep_shard_axes,
            moe_token_axes=(ctx.batch_axes, ctx.sequence_axes))
        sdpa = (j_eager_sdpa if self.ring is None else j_make_ring_sdpa(
            ctx.mesh, head_axes=tuple(self.ring), impl="eager"))
        return JQwen3MoeCausalLM(config=cfg, sdpa=sdpa, stage=stage,
                                 dtype=jnp.float32)

    def build_plan(self, ctx):
        return j_fsdp_ep_plan(ctx, with_tp=self.with_tp)

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
    mesh, plan, ring = CASES[name]
    jp = JMeshParameters(**mesh)
    ctx = jp.build(jax.devices()[:jp.world_size])
    return JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(ctx, ring, plan.endswith("tp")),
        dataset_provider=_JData(batches), task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)


def _jax_run(name, jtr):
    """Initial and final parameters, history, and each expert weight's
    shards, device by device (initial and final)."""
    devices = list(jtr.ctx.mesh.devices.flat)

    def shards(prefix):
        out = {}
        for key, leaf in flatten_dict(jtr.params["params"], sep="/").items():
            out[f"{prefix}/{key}"] = np.asarray(leaf)
            if "grouped_experts" in key:
                by = {s.device: np.asarray(s.data)
                      for s in leaf.addressable_shards}
                out[f"{prefix}_shards/{key}"] = np.stack(
                    [by[d] for d in devices])
        return out

    out = shards("init")
    hist = jtr.train()
    out.update({f"hist/{k}": np.array([h[k] for h in hist]) for k in KEYS})
    out.update(shards("param"))
    return {f"{name}/{k}": v for k, v in out.items()}


def _start_port(tmp, world, names, dispatch, data_path):
    cases = {n: dict(mesh=CASES[n][0], plan=CASES[n][1], ring=CASES[n][2])
             for n in names}
    spec = tmp / f"port{world}.json"
    spec.write_text(json.dumps(dict(
        lr=LR, wd=WD, keys=KEYS, cases=cases, dispatch=dispatch,
        capacities=CAPACITIES, experts=DE, train=TRAIN,
        model=dict(MODEL, vocab_ranges=[list(r) for r in
                                        MODEL["vocab_ranges"]]))))
    sub = tmp / f"spawn{world}"
    sub.mkdir()
    wait = spawn(sub, WORKER, world, spec, data_path, tmp / f"out{world}_")

    def ranks():
        wait()
        return [dict(np.load(tmp / f"out{world}_{r}.npz"))
                for r in range(world)]

    return ranks


class _TData(DatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


class _TModel(ModelProvider):
    def __init__(self, flat):
        self.flat = flat

    def build_module(self, ctx):
        model = _port_model(seed=None)
        load_jax_params(model, self.flat)
        return model


def _port_model(seed=0):
    return Qwen3MoeCausalLM(Qwen3MoeConfig(**MODEL), dtype=torch.float32,
                            device="cpu", seed=seed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    batches = _batches()
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"ids{i}"] = b["input_ids"]
        arrays[f"mask{i}"] = b["loss_mask"]
    for w in (2, 4):
        arrays.update({f"d{w}/{k}": v
                       for k, v in _dispatch_inputs(w).items()})
    first = _build_jax(JAX_CASES[0], batches)
    weights = _flat(first.params)
    arrays.update({f"w/{k}": v for k, v in weights.items()})
    np.savez(tmp / "run.npz", **arrays)
    port4 = _start_port(tmp, 4, ("dp_tp_ep", "dp_r_cp_ep"),
                        [d for d in DISPATCH if d[0] == 4], tmp / "run.npz")
    port2 = _start_port(tmp, 2, ("dp_ep", "dp_local", "dp_ep_legacy"),
                        [d for d in DISPATCH if d[0] == 2], tmp / "run.npz")
    jax_out = _jax_run(JAX_CASES[0], first)
    for name in JAX_CASES[1:]:
        jax_out.update(_jax_run(name, _build_jax(name, batches)))
    dispatch = {f"d{w}_{c}": v for w in (2, 4)
                for c, v in _jax_dispatch(w).items()}
    one = Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(**TRAIN),
        model_provider=_TModel(weights), dataset_provider=_TData(batches),
        task=CausalLMTask(),
        optimizer_provider=AdamWProvider(weight_decay=WD), learning_rate=LR)
    one_hist = one.train()
    one_final = {n: p.detach().numpy().copy()
                 for n, p in one.module.named_parameters()}
    return dict(port2=port2(), port4=port4(), jax=jax_out, weights=weights,
                dispatch=dispatch, one=(one_hist, one_final))


def _ranks(runs, name):
    return runs["port4"] if _world(CASES[name][0]) == 4 else runs["port2"]


@pytest.mark.parametrize("w,capacity", DISPATCH,
                         ids=[f"w{w}-{c}" for w, c in DISPATCH])
def test_dispatch_matches_jax(runs, w, capacity):
    """Output and gradients against JAX's dispatch; dropped pairs (a zero
    prob gradient) are the same pairs, none without a capacity that
    overflows, some at capacity 1.0."""
    want = runs["dispatch"][f"d{w}_{capacity}"]
    ranks = runs["port4"] if w == 4 else runs["port2"]
    tag = f"d{w}_{capacity}"
    n, e_loc = DN, DE // w
    got = {k: np.concatenate([r[f"{tag}/{k}"] for r in ranks])
           for k in ("out", "dx", "dprobs", "dgate", "dup", "ddown")}
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], **DISPATCH_TOL, err_msg=k)
    assert got["dgate"].shape[0] == w * e_loc
    dropped = sum(int(r[f"{tag}/dropped"]) for r in ranks)
    np.testing.assert_array_equal(got["dprobs"] == 0, want["dprobs"] == 0)
    assert int((want["dprobs"] == 0).sum()) == dropped
    assert (dropped > 0) == (capacity == "tight"), dropped
    for r in ranks:
        # one count all-gather, a dispatch and a return trip, and the
        # return trip's mirror and the dispatch's in the backward
        assert (int(r[f"{tag}/readbacks"]), int(r[f"{tag}/a2a_calls"])) == (
            1, 4)
    assert got["out"].shape == (w * n, DD)


def _check_ranks_equal(ranks, name):
    r0 = ranks[0]
    for r in ranks[1:]:
        for f in r0:
            if f.startswith((f"{name}/hist/", f"{name}/full/")):
                np.testing.assert_array_equal(r0[f], r[f], err_msg=f)


@pytest.mark.parametrize("name", JAX_CASES)
def test_ep_trainer_matches_jax(runs, name):
    """Loss, grad norm and load fraction per step, and the gathered final
    parameters, against JAX's Trainer on the same mesh."""
    ranks, jx = _ranks(runs, name), runs["jax"]
    for key, value in runs["weights"].items():
        np.testing.assert_array_equal(jx[f"{name}/init/{key}"], value,
                                      err_msg=f"{name} init: {key}")
    _check_ranks_equal(ranks, name)
    r0 = ranks[0]
    for key in KEYS[:3]:
        np.testing.assert_allclose(r0[f"{name}/hist/{key}"],
                                   jx[f"{name}/hist/{key}"], **STEP_TOL,
                                   err_msg=f"{name} vs JAX: {key}")
    np.testing.assert_array_equal(r0[f"{name}/hist/task/moe_load_max_frac"],
                                  jx[f"{name}/hist/task/moe_load_max_frac"])
    want = _port_model(seed=None)
    prefix = f"{name}/param/"
    load_jax_params(want, {k[len(prefix):]: v for k, v in jx.items()
                           if k.startswith(prefix)})
    for pname, w in want.named_parameters():
        np.testing.assert_allclose(r0[f"{name}/full/{pname}"],
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=f"{name} vs JAX: {pname}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_expert_pieces_match_the_jax_shards(runs, name):
    """Each rank holds the experts of its ep index: the shape and initial
    values of the JAX shard at its mesh coordinate, its final values
    within the parameter tolerance; the other parameters' pieces follow
    the fsdp and tp cuts."""
    ranks, jx = _ranks(runs, name), runs["jax"]
    model = _port_model(seed=None)
    keys = [k[len(f"{name}/param/"):] for k in jx
            if k.startswith(f"{name}/param/")]
    seen = 0
    ep = CASES[name][0]["ep_shard"]
    for pname, (key,) in jax_param_map(model, keys).items():
        if "grouped_experts" not in pname:
            continue
        init = jx[f"{name}/init_shards/{key}"]
        final = jx[f"{name}/param_shards/{key}"]
        for r, out in enumerate(ranks):
            piece = out[f"{name}/piece/{pname}"]
            assert piece.shape == init[r].shape, (pname, r)
            assert piece.shape[0] * ep == MODEL["num_experts"]
            np.testing.assert_array_equal(out[f"{name}/piece0/{pname}"],
                                          init[r], err_msg=f"{pname} {r}")
            np.testing.assert_allclose(piece, final[r], **PARAM_TOL,
                                       err_msg=f"{pname} {r}")
            seen += 1
    assert seen == 3 * len(ranks)
    assert sorted(int(r[f"{name}/ep_rank"]) for r in ranks) == sorted(
        list(range(ep)) * (len(ranks) // ep))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_init_is_the_one_process_build(runs, name):
    """The pieces each rank draws from the seed, the expert slices among
    them, gathered, are the one-process build's parameters bit for bit."""
    want = {n: p.detach().numpy() for n, p in
            _port_model(seed=0).named_parameters()}
    for r in _ranks(runs, name):
        for pname, w in want.items():
            np.testing.assert_array_equal(r[f"{name}/init/{pname}"], w,
                                          err_msg=f"{name}: {pname}")


def test_local_experts_on_a_dp_mesh(runs):
    """dp_shard 2 under fsdp_plan with local experts (the expert weights
    whole on each rank, their gradients summed by the step) against the
    port's one-process Trainer."""
    ranks = runs["port2"]
    one_hist, one_final = runs["one"]
    _check_ranks_equal(ranks, "dp_local")
    r0 = ranks[0]
    for key in KEYS:
        np.testing.assert_allclose(r0[f"dp_local/hist/{key}"],
                                   [h[key] for h in one_hist], **STEP_TOL,
                                   err_msg=key)
    for pname, w in one_final.items():
        np.testing.assert_allclose(r0[f"dp_local/full/{pname}"], w,
                                   **PARAM_TOL, err_msg=pname)
    assert tuple(r0["dp_local/shape/model.layers.0.mlp.grouped_experts"
                    ".gate_proj"]) == (MODEL["num_experts"], 64, 64)


def test_legacy_flow_is_the_token_flow_where_ported(runs):
    """token_axes=None at dp_shard 2 x ep_shard 2: the global flatten cut
    over the ep axes is each rank's own block, so the run is the token
    flow's bit for bit."""
    r0 = runs["port2"][0]
    for key in [k for k in r0 if k.startswith(("dp_ep/hist/", "dp_ep/full/"))]:
        np.testing.assert_array_equal(
            r0[key.replace("dp_ep/", "dp_ep_legacy/", 1)], r0[key],
            err_msg=key)
