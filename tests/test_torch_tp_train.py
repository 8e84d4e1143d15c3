"""Tensor parallelism and ``cp_replicate`` in the port: ``Trainer`` under
``tp_plan`` and ``fsdp_plan``/``hsdp_plan(with_tp=True)`` in gloo
processes on the CPU vs the JAX ``Trainer`` on the same mesh of the suite's
virtual CPU devices.

Cases (``Qwen3DenseConfig.tiny()``: 2 layers, 4/2 heads of 16, hidden 64,
vocab 256):

- ``tp``: ``tp 2``, ``tp_plan``, 2 ranks;
- ``dp_s_tp``: ``dp_shard 2 x tp 2``, ``fsdp_plan(with_tp=True)``;
- ``dp_r_tp``: ``dp_replicate 2 x tp 2``, ``hsdp_plan(with_tp=True)``
  (the fsdp axes are 1: tensor parallelism and two replicas);
- ``cp_s_tp`` and ``cp_s_tp_sinks``: ``cp_shard 2 x tp 2``,
  ``fsdp_plan(with_tp=True)``, the ring over each rank's head slice
  (``head_axes=("tp",)``), the second with ``use_sinks``;
- ``cp_s_cp_r``: ``cp_shard 2 x cp_replicate 2``, ``fsdp_plan``, the ring
  (JAX's ``test_cp_with_tp_trains`` mesh without tp).

The 4-rank cases run one after the other in one spawn of 4 processes, the
``tp`` case in a spawn of 2, which also holds the vocab-parallel embedding,
LM-head CE and logits against the whole-table versions, forward and
gradient. The JAX trainers run meanwhile in this process, one after the
other. Every run starts from the first JAX trainer's initial weights (each
JAX run's are checked equal to them), carried into the port's
pieces by ``load_jax_params``; the batches come from a numpy seed.

Tolerances are ``tests/test_torch_dp_train.py``'s: loss and grad norm per
step within rtol 1e-4, final parameters (gathered) within rtol/atol 1e-3
(sums in other orders, carried by Adam's normalized update). Every rank's
history and gathered parameters are equal bit for bit. Each rank's piece
of every parameter has the shape of the JAX array's shard on the device at
the same mesh coordinate; the gathered initial pieces equal the
one-process build bit for bit. ``dp_s_tp_bf16`` trains bf16 parameters
with ``StochasticAdamW`` at ``dp_shard 2 x tp 2`` against the one-process
bf16 run under the dp test's rule (step 1 within rtol 1e-4, later steps
within one bf16 ulp, at least 75 % of each bf16 parameter's elements bit
for bit equal), its B10 roundings at the block pieces' offsets.
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
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.ops.attention.ring import make_ring_sdpa as j_make_ring_sdpa
from d9d_tpu.parallel import fsdp_plan as j_fsdp_plan
from d9d_tpu.parallel import hsdp_plan as j_hsdp_plan
from d9d_tpu.parallel import tp_plan as j_tp_plan
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
)
from d9d_tpu_torch.model_state.from_jax import jax_param_map, load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.logical_axes import param_layouts
from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from test_torch_dp_train import MODEL as DP_MODEL
from test_torch_dp_train import TRAIN as DP_TRAIN
from test_torch_dp_train import _batches as _dp_batches
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=0.0)
ROUNDED_STEP_TOL = dict(rtol=2.0 ** -8, atol=0.0)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
# the vocab-parallel CE against the whole table's, fp32: the row max and
# the sum of exps are reduced over ranks (sums in another order)
CE_TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_torch_dp_train.py's bound, which it measured on its model and
# steps (DP_MODEL, DP_TRAIN): the bf16 case at dp_shard 2 x tp 2 runs there.
# At tiny() widths the row split alone (dp_shard 2, no tp) leaves 0.743 of
# a q_proj bit for bit equal after 3 steps, and tp 2 alone 0.98 (the
# ``tp_bf16`` case holds it to the same bound at tiny() widths)
BF16_EQUAL_SHARE = 0.75
VOCAB, STEPS, GBS, MBS, SEQ, LR, WD = 256, 3, 8, 4, 32, 1e-2, 0.1
# tiny()'s widths at 1 of its 2 layers: the JAX trainers' compiles bound
# the file's time
MODEL = dict(vocab_ranges=(("default", VOCAB),), hidden_size=64, num_layers=1,
             num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
             remat=False)
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=STEPS, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/tokens")
# name: (mesh, plan, ring head axes or None, use_sinks)
CASES = {
    "tp": (dict(tp=2), "tp", None, False),
    "dp_s_tp": (dict(dp_shard=2, tp=2), "fsdp_tp", None, False),
    "dp_r_tp": (dict(dp_replicate=2, tp=2), "hsdp_tp", None, False),
    "cp_s_tp": (dict(cp_shard=2, tp=2), "fsdp_tp", ["tp"], False),
    "cp_s_tp_sinks": (dict(cp_shard=2, tp=2), "fsdp_tp", ["tp"], True),
    "cp_s_cp_r": (dict(cp_shard=2, cp_replicate=2), "fsdp", [], False),
}
PORT_4 = ("dp_s_tp", "dp_r_tp", "cp_s_tp", "cp_s_tp_sinks", "cp_s_cp_r",
          "dp_s_tp_bf16")
PORT_2 = ("tp", "tp_bf16")
# the bf16 cases: (model, batches' prefix in the data file, trainer config)
BF16 = {"tp_bf16": (MODEL, "", TRAIN),
        "dp_s_tp_bf16": (DP_MODEL, "dp_", DP_TRAIN)}


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
from d9d_tpu_torch.loop import (AdamWConfig, CausalLMTask, DatasetProvider,
                                ModelProvider, OptimizerProvider,
                                StochasticAdamWConfig, Trainer, TrainerConfig,
                                build_optimizer)
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.sdpa import SdpaFlashConfig, SdpaRingConfig
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.ops.linear_ce import linear_cross_entropy
from d9d_tpu_torch.ops.stochastic import shard_index, stochastic_round_to_bf16
from d9d_tpu_torch.parallel import fsdp_plan, hsdp_plan, tp_plan
from d9d_tpu_torch.parallel.plan import apply_plan
from d9d_tpu_torch.parallel.shards import (is_sharded, local_piece,
                                           local_tensor, shard_bounds)
from d9d_tpu_torch.parallel.shards import vocab_slice

torch.set_num_threads(1)
rank, world, rdzv, spec_path, data_path, dst = sys.argv[1:7]
rank, world = int(rank), int(world)
spec = json.load(open(spec_path))
data = np.load(data_path)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
PLANS = {"tp": tp_plan, "fsdp": fsdp_plan,
         "fsdp_tp": lambda c: fsdp_plan(c, with_tp=True),
         "hsdp_tp": lambda c: hsdp_plan(c, with_tp=True)}


def full(p):
    p = p.detach()
    whole = p.full_tensor() if is_sharded(p) else p
    return whole.float().numpy().copy()


def run_case(name, mesh, plan, ring, sinks, bf16, model, batch, train):
    ctx = MeshParameters(**mesh).build(["cpu"] * world)
    cfg = dict(model, use_sinks=sinks)
    cfg["vocab_ranges"] = tuple(tuple(r) for r in cfg["vocab_ranges"])
    batches = [{"input_ids": data[f"{batch}ids{i}"],
                "loss_mask": data[f"{batch}mask{i}"]}
               for i in range(train["total_steps"])]

    class Model(ModelProvider):
        def build_module(self, ctx):
            sdpa = (build_sdpa_backend(SdpaRingConfig(head_axes=tuple(ring)),
                                       ctx=ctx) if ring is not None
                    else build_sdpa_backend(SdpaFlashConfig()))
            return Qwen3DenseCausalLM(
                Qwen3DenseConfig(**cfg), sdpa, dtype=torch.float32,
                param_dtype=torch.bfloat16 if bf16 else torch.float32,
                device=ctx.device, seed=0)

        def build_plan(self, ctx):
            return PLANS[plan](ctx)

    class Opt(OptimizerProvider):
        def build(self, params, learning_rate):
            cls = StochasticAdamWConfig if bf16 else AdamWConfig
            return build_optimizer(cls(weight_decay=spec["wd"]), params,
                                   learning_rate)

    class Data(DatasetProvider):
        def build(self):
            return iter(batches)

    trainer = Trainer(
        ctx=ctx, config=TrainerConfig(**train),
        model_provider=Model(), dataset_provider=Data(), task=CausalLMTask(),
        optimizer_provider=Opt(), learning_rate=spec["lr"])
    out = {}
    for pname, p in trainer.module.named_parameters():
        out[f"shape/{pname}"] = np.array(local_tensor(p.detach()).shape)
        out[f"init/{pname}"] = full(p)
    if name == "dp_s_tp":
        b10_pieces(trainer.module, out)
    if not bf16:
        prefix = "w_sinks/" if sinks else "w/"
        load_jax_params(trainer.module, {k[len(prefix):]: data[k]
                                         for k in data.files
                                         if k.startswith(prefix)})
    seen = []
    trainer.module.lm_head.register_forward_pre_hook(
        lambda m, args: seen.append(vocab_slice(m.weight)[:2]))
    hist = trainer.train()
    rows = {(r.shape[0], lo) for r, lo in seen}
    out["head_rows"] = np.array(sorted(rows)[0] + (len(rows),))
    for key in spec["keys"]:
        out[f"hist/{key}"] = np.array([h[key] for h in hist])
    for pname, p in trainer.module.named_parameters():
        out[f"full/{pname}"] = full(p)
    out["eval_loss"] = np.float64(trainer.loss_on_batch(batches[0]))
    out["tp_rank"] = np.int64(ctx.tp_rank)
    return {f"{name}/{k}": v for k, v in out.items()}


def b10_pieces(module, out):
    """A block piece (q_proj: tp on dim 0, fsdp on dim 1) and a strided
    piece (the embedding: tp outer, fsdp inner on dim 0): the bounds give
    the DTensor's own piece of its full tensor, and B10's plain version at
    the piece's offsets rounds it to the whole tensor's bits."""
    for pname in ("model.layers.0.self_attn.q_proj.weight",
                  "model.embed_tokens.weight"):
        p = module.get_parameter(pname).detach()
        whole = p.full_tensor()
        bounds = shard_bounds(p)
        off, cols, stride = shard_index(tuple(whole.shape), bounds)
        piece = local_tensor(p)
        got = stochastic_round_to_bf16(piece, 77, index_offset=off, cols=cols,
                                       row_stride=stride)
        want = local_piece(stochastic_round_to_bf16(whole, 77), p)
        out[f"b10/{pname}"] = np.array([
            len(bounds), torch.equal(local_piece(whole, p), piece),
            torch.equal(got.view(torch.int16), want.view(torch.int16))])


def vocab_checks(ctx):
    """The vocab-parallel embedding, CE (one chunk, and 3 chunks with a
    logit softcap) and logits against the whole-table versions: values and
    gradients, each rank's pieces."""
    out = {}
    rng = np.random.default_rng(5)
    v, d, n = 40, 8, 24
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    hidden = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, n))
    labels[::5] = -100
    ids = torch.from_numpy(rng.integers(0, v, (2, 7)))
    for cls, name in ((TokenEmbedding, "emb"), (LanguageModellingHead, "head")):
        mod = cls((("a", 30), ("b", 10)), d, dtype=torch.float32,
                  device="cpu", generator=None)
        with torch.no_grad():
            mod.weight.copy_(table)
        apply_plan(mod, ctx, tp_plan(ctx))
        out[f"vocab/{name}_rows"] = np.array(local_tensor(mod.weight).shape)
        if name == "emb":
            got = mod(ids)
            got.pow(2).sum().backward()
            out["vocab/emb"] = got.detach().numpy()
        else:
            h = hidden.clone().requires_grad_()
            got = mod(h[None], labels[None])[0]
            (got * torch.arange(n)).sum().backward()
            out["vocab/ce"] = got.detach().numpy()
            out["vocab/ce_dh"] = h.grad.numpy()
            with torch.no_grad():
                out["vocab/logits"] = mod.logits(hidden).numpy()
            rows, lo, group = vocab_slice(mod.weight)
            h2 = hidden.clone().requires_grad_()
            w2 = local_tensor(mod.weight).detach().clone().requires_grad_()
            ce = linear_cross_entropy(h2, w2, labels, chunk_size=10,
                                      logit_softcap=3.0, vocab_start=lo,
                                      group=group)
            ce.sum().backward()
            out["vocab/ce_chunked"] = ce.detach().numpy()
            out["vocab/ce_chunked_dh"] = h2.grad.numpy()
            out["vocab/ce_chunked_dw"] = w2.grad.numpy()
            out["vocab/start"] = np.int64(lo)
        out[f"vocab/{name}_dw"] = local_tensor(mod.weight.grad).numpy()
    return out


out = {}
for name, case in spec["cases"].items():
    if name == "tp":
        ctx = MeshParameters(**case["mesh"]).build(["cpu"] * world)
        out.update(vocab_checks(ctx))
    out.update(run_case(name, **case))
np.savez(f"{dst}{rank}.npz", **out)
assert "jax" not in sys.modules
shutdown_distributed()
'''

class _JModel(JModelProvider):
    def __init__(self, sdpa, plan, sinks):
        self.sdpa, self.plan, self.sinks = sdpa, plan, sinks

    def build_module(self, stage):
        return JQwen3DenseCausalLM(
            config=JQwen3DenseConfig(**MODEL, use_sinks=self.sinks),
            sdpa=self.sdpa, stage=stage, dtype=jnp.float32)

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


def _flat(tree):
    """The trainer's parameters by path, without the ``params/``
    collection."""
    return {k[len("params/"):]: np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def _build_jax(name, batches):
    mesh, plan, ring, sinks = CASES[name]
    jp = JMeshParameters(**mesh)
    ctx = jp.build(jax.devices()[:jp.world_size])
    plans = {"tp": j_tp_plan, "fsdp": j_fsdp_plan,
             "fsdp_tp": lambda c: j_fsdp_plan(c, with_tp=True),
             "hsdp_tp": lambda c: j_hsdp_plan(c, with_tp=True)}
    # the ring's blocks in plain jnp (the Pallas block in interpret mode is
    # held to it in tests/test_torch_ring.py)
    sdpa = (j_eager_sdpa if ring is None else j_make_ring_sdpa(
        ctx.mesh, head_axes=tuple(ring), impl="eager"))
    return JTrainer(
        ctx=ctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(sdpa, plans[plan], sinks),
        dataset_provider=_JData(batches), task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)


def _jax_run(name, jtr):
    """Train the JAX trainer of case ``name``: its initial and final
    parameters, its history and the shapes of its shards, device by
    device."""
    out = {f"{name}/init/{k}": v for k, v in _flat(jtr.params).items()}
    hist = jtr.train()
    out.update({f"{name}/hist/{k}": np.array([h[k] for h in hist])
                for k in KEYS})
    devices = list(jtr.ctx.mesh.devices.flat)
    for key, leaf in flatten_dict(jtr.params["params"], sep="/").items():
        out[f"{name}/param/{key}"] = np.asarray(leaf)
        shards = {s.device: s.data.shape for s in leaf.addressable_shards}
        out[f"{name}/shards/{key}"] = np.array([shards[d] for d in devices])
    return out


def _start_port(tmp_path, world, names, data_path):
    cases = {}
    for name in names:
        mesh, plan, ring, sinks = CASES[name.replace("_bf16", "")]
        model, batch, train = BF16.get(name, (MODEL, "", TRAIN))
        cases[name] = dict(mesh=mesh, plan=plan, ring=ring, sinks=sinks,
                           bf16=name in BF16, model=model, batch=batch,
                           train=train)
    spec = tmp_path / f"port{world}.json"
    spec.write_text(json.dumps(dict(lr=LR, wd=WD, keys=KEYS, cases=cases)))
    sub = tmp_path / f"spawn{world}"
    sub.mkdir()
    wait = spawn(sub, WORKER, world, spec, data_path,
                 tmp_path / f"out{world}_")

    def ranks():
        wait()
        return [dict(np.load(tmp_path / f"out{world}_{r}.npz"))
                for r in range(world)]

    return ranks


class _TData(DatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


class _TModel(ModelProvider):
    def __init__(self, model):
        self.model = model

    def build_module(self, ctx):
        return Qwen3DenseCausalLM(
            Qwen3DenseConfig(**self.model),
            build_sdpa_backend(SdpaFlashConfig()), dtype=torch.float32,
            param_dtype=torch.bfloat16, device=ctx.device, seed=0)


class _TOpt(OptimizerProvider):
    def build(self, params, learning_rate):
        return build_optimizer(StochasticAdamWConfig(weight_decay=WD), params,
                               learning_rate)


def _one_process_bf16(model, batch, train):
    """The one-process run of a bf16 case: initial and final parameters,
    history, and which parameters are bf16."""
    batches = _dp_batches() if batch == "dp_" else _batches()
    one = Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(**train),
        model_provider=_TModel(model), dataset_provider=_TData(batches),
        task=CausalLMTask(), optimizer_provider=_TOpt(), learning_rate=LR)

    def params():
        return {n: p.detach().float().numpy().copy()
                for n, p in one.module.named_parameters()}

    init = params()
    hist = one.train()
    return dict(init=init, hist=hist, final=params(), narrow={
        n: p.dtype == torch.bfloat16 for n, p in one.module.named_parameters()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's port ranks and JAX run, and the one-process bf16
    run."""
    tmp = tmp_path_factory.mktemp("tp_train")
    batches = _batches()
    arrays = {}
    for prefix, bs in (("", batches), ("dp_", _dp_batches())):
        for i, b in enumerate(bs):
            arrays[f"{prefix}ids{i}"] = b["input_ids"]
            arrays[f"{prefix}mask{i}"] = b["loss_mask"]
    first = _build_jax("tp", batches)
    weights = _flat(first.params)
    arrays.update({f"w/{k}": v for k, v in weights.items()})
    arrays.update({f"w_sinks/{k}": v for k, v in weights.items()})
    for i in range(MODEL["num_layers"]):  # the sinks start at zero
        arrays[f"w_sinks/model/layers_{i}/self_attn/sinks"] = np.zeros(
            MODEL["num_heads"], np.float32)
    np.savez(tmp / "run.npz", **arrays)
    port4 = _start_port(tmp, 4, PORT_4, tmp / "run.npz")
    port2 = _start_port(tmp, 2, PORT_2, tmp / "run.npz")
    jax_out = _jax_run("tp", first)
    for name in list(CASES)[1:]:
        jax_out.update(_jax_run(name, _build_jax(name, batches)))
    bf16 = {name: _one_process_bf16(model, batch, train)
            for name, (model, batch, train) in BF16.items()}
    carried = {k: arrays[k] for k in arrays if k.startswith("w")}
    return dict(port2=port2(), port4=port4(), jax=jax_out, bf16=bf16,
                carried=carried)


def _ranks(runs, name):
    return runs["port2"] if name in PORT_2 else runs["port4"]


def _port_model(sinks=False, seed=None):
    return Qwen3DenseCausalLM(Qwen3DenseConfig(**MODEL, use_sinks=sinks),
                              dtype=torch.float32, device="cpu", seed=seed)


def _check_ranks_equal(ranks, name):
    r0 = ranks[0]
    for r in ranks[1:]:
        for f in r0:
            if f.startswith((f"{name}/hist/", f"{name}/full/",
                             f"{name}/eval_loss")):
                np.testing.assert_array_equal(r0[f], r[f], err_msg=f)


def _check_against_jax(runs, name):
    ranks, jx = _ranks(runs, name), runs["jax"]
    # both sides start from the weights carried into the port's pieces
    prefix = "w_sinks/" if CASES[name][3] else "w/"
    carried = {k[len(prefix):]: v for k, v in runs["carried"].items()
               if k.startswith(prefix)}
    jax_init = {k[len(f"{name}/init/"):]: v for k, v in jx.items()
                if k.startswith(f"{name}/init/")}
    assert jax_init.keys() == carried.keys()
    for key, value in carried.items():
        np.testing.assert_array_equal(jax_init[key], value,
                                      err_msg=f"{name} init: {key}")
    _check_ranks_equal(ranks, name)
    r0 = ranks[0]
    for key in KEYS:
        np.testing.assert_allclose(r0[f"{name}/hist/{key}"],
                                   jx[f"{name}/hist/{key}"], **STEP_TOL,
                                   err_msg=f"{name} vs JAX: {key}")
    assert all(w < GBS * SEQ for w in r0[f"{name}/hist/loss_weight"])
    sinks = CASES[name][3]
    want = _port_model(sinks)
    prefix = f"{name}/param/"
    load_jax_params(want, {k[len(prefix):]: v for k, v in jx.items()
                           if k.startswith(prefix)})
    for pname, w in want.named_parameters():
        np.testing.assert_allclose(r0[f"{name}/full/{pname}"],
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=f"{name} vs JAX: {pname}")


def test_tp_plan_trains_as_jax(runs):
    _check_against_jax(runs, "tp")


def test_fsdp_with_tp_trains_as_jax(runs):
    _check_against_jax(runs, "dp_s_tp")


def test_hsdp_with_tp_trains_as_jax(runs):
    _check_against_jax(runs, "dp_r_tp")


@pytest.mark.parametrize("name", ["cp_s_tp", "cp_s_tp_sinks"])
def test_ring_over_head_slices_trains_as_jax(runs, name):
    _check_against_jax(runs, name)
    # the sinks moved: they are trained, each rank on its heads' slice
    if name.endswith("sinks"):
        r0 = _ranks(runs, name)[0]
        moved = r0[f"{name}/full/model.layers.0.self_attn.sinks"]
        assert np.abs(moved).min() > 0
        assert tuple(r0[f"{name}/shape/model.layers.0.self_attn.sinks"]) == (
            MODEL["num_heads"] // 2,)


def test_cp_replicate_trains_as_jax(runs):
    _check_against_jax(runs, "cp_s_cp_r")


@pytest.mark.parametrize("name", [n for n in CASES])
def test_shard_shapes_match_jax(runs, name):
    """Each rank's piece of every parameter has the shape of the JAX
    array's shard on the device at the same mesh coordinate."""
    ranks, jx = _ranks(runs, name), runs["jax"]
    model = _port_model(CASES[name][3])
    layouts = param_layouts(model)
    keys = [k[len(f"{name}/param/"):] for k in jx
            if k.startswith(f"{name}/param/")]
    cut = 0
    for pname, (key,) in jax_param_map(model, keys).items():
        shards = jx[f"{name}/shards/{key}"]
        for r, out in enumerate(ranks):
            want = tuple(shards[r])
            if layouts[pname].transposed:
                want = want[::-1]
            assert tuple(out[f"{name}/shape/{pname}"]) == want, (pname, r)
        cut += tuple(shards[0]) != jx[f"{name}/param/{key}"].shape
    assert cut > 0


@pytest.mark.parametrize("name", list(CASES) + list(BF16))
def test_sharded_init_is_the_one_process_build(runs, name):
    """The pieces each rank draws from the seed, gathered, are the
    one-process build's parameters bit for bit."""
    if name in BF16:
        want = runs["bf16"][name]["init"]
    else:
        want = {n: p.detach().numpy() for n, p in
                _port_model(CASES[name][3], seed=0).named_parameters()}
    for r in _ranks(runs, name):
        for pname, w in want.items():
            np.testing.assert_array_equal(r[f"{name}/init/{pname}"], w,
                                          err_msg=f"{name}: {pname}")


@pytest.mark.parametrize("name", [n for n in CASES if "tp" in CASES[n][0]])
def test_head_holds_only_its_vocab_rows(runs, name):
    """During every forward of the step each rank's LM-head table is its
    tp slice of the vocab rows (the CE never gathers the table)."""
    for r in _ranks(runs, name):
        rows, start, kinds = r[f"{name}/head_rows"]
        tp_rank = int(r[f"{name}/tp_rank"])
        assert (rows, start, kinds) == (VOCAB // 2, tp_rank * VOCAB // 2, 1)


def test_vocab_parallel_pieces_match_the_whole_table(runs):
    """The embedding's lookup, the head's CE (one chunk; three chunks with
    a softcap) and logits, against the whole table's, and the gradients:
    each rank's table gradient is its rows' of the whole gradient."""
    from d9d_tpu_torch.ops.linear_ce import linear_cross_entropy

    rng = np.random.default_rng(5)
    v, d, n = 40, 8, 24
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    hidden = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, n))
    labels[::5] = -100
    ids = torch.from_numpy(rng.integers(0, v, (2, 7)))
    w = table.clone().requires_grad_()
    emb = torch.nn.functional.embedding(ids, w)
    emb.pow(2).sum().backward()
    emb_dw = w.grad
    w = table.clone().requires_grad_()
    h = hidden.clone().requires_grad_()
    ce = linear_cross_entropy(h, w, labels)
    (ce * torch.arange(n)).sum().backward()
    ce_dw, ce_dh = w.grad, h.grad
    w = table.clone().requires_grad_()
    h = hidden.clone().requires_grad_()
    chunked = linear_cross_entropy(h, w, labels, chunk_size=10,
                                   logit_softcap=3.0)
    chunked.sum().backward()
    for r in runs["port2"]:
        lo = int(r["vocab/start"])
        rows = slice(lo, lo + v // 2)
        assert tuple(r["vocab/emb_rows"]) == tuple(r["vocab/head_rows"]) == (
            v // 2, d)
        np.testing.assert_array_equal(r["vocab/emb"], emb.detach().numpy())
        np.testing.assert_array_equal(r["vocab/emb_dw"], emb_dw[rows].numpy())
        np.testing.assert_allclose(r["vocab/ce"], ce.detach().numpy(),
                                   **CE_TOL)
        np.testing.assert_allclose(r["vocab/ce_dh"], ce_dh.numpy(), **CE_TOL)
        np.testing.assert_allclose(r["vocab/head_dw"], ce_dw[rows].numpy(),
                                   **CE_TOL)
        np.testing.assert_allclose(r["vocab/logits"],
                                   (hidden @ table.T).numpy(), **CE_TOL)
        np.testing.assert_allclose(r["vocab/ce_chunked"],
                                   chunked.detach().numpy(), **CE_TOL)
        np.testing.assert_allclose(r["vocab/ce_chunked_dh"], h.grad.numpy(),
                                   **CE_TOL)
        np.testing.assert_allclose(r["vocab/ce_chunked_dw"],
                                   w.grad[rows].numpy(), **CE_TOL)


def test_b10_on_block_and_strided_pieces(runs):
    """``shard_bounds`` names the DTensor's own piece of its full tensor,
    and B10's plain version at ``shard_index``'s offsets rounds the piece
    to the whole tensor's bits, for a block (q_proj: two cut dims) and a
    strided vocab piece, on every rank."""
    for r in runs["port4"]:
        for pname, cut_dims in (("model.layers.0.self_attn.q_proj.weight", 2),
                                ("model.embed_tokens.weight", 1)):
            assert r[f"dp_s_tp/b10/{pname}"].tolist() == [cut_dims, 1, 1]


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_stochastic_adamw_under_tp(runs, name):
    """bf16 parameters and StochasticAdamW at tp 2 (tiny() widths) and at
    dp_shard 2 x tp 2 (the dp test's model) against the one-process bf16
    run."""
    ranks, one = _ranks(runs, name), runs["bf16"][name]
    _check_ranks_equal(ranks, name)
    r0 = ranks[0]
    for key in ("loss", "grad_norm"):
        got = r0[f"{name}/hist/{key}"]
        want = [h[key] for h in one["hist"]]
        np.testing.assert_allclose(got[:1], want[:1], **STEP_TOL, err_msg=key)
        np.testing.assert_allclose(got, want, **ROUNDED_STEP_TOL, err_msg=key)
    for pname, want in one["final"].items():
        got = r0[f"{name}/full/{pname}"]
        if one["narrow"][pname]:
            assert (got == want).mean() >= BF16_EQUAL_SHARE, pname
        else:  # the fp32 layer norms: sums in other orders
            np.testing.assert_allclose(got, want, **PARAM_TOL, err_msg=pname)
