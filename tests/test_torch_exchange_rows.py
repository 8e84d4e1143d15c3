"""The legacy EP flow's row exchange at ``dp_replicate 3`` (ROADMAP C7) and
the decode wrappers' head-dim check (ROADMAP C8).

C7: ``core/collectives.py`` ``exchange_rows`` gathers copies of the rows
repeated as often as a row is sent (``copy_pairs``), so its gather never
names a row twice and its backward is a collision-free gather and one
sum over each row's copies in a fixed order. Checked here: the pairs
name no row twice and map back to the rows; the legacy routes of a
``dp_r 3 x dp_s 2, ep 2`` mesh send each row 3 times as distinct pairs;
the forward equals the gather by repeated rows and the gradient its
gradient (fp64, exact); and ``Trainer`` on that mesh in the legacy flow
(6 gloo processes; every gradient of the layers below the MoE layer
crosses ``exchange_rows``' backward) against JAX's ``Trainer`` in its
legacy flow on 6 of the suite's virtual devices, from the same weights:
loss and grad norm within ``STEP_TOL``, final parameters within
``PARAM_TOL`` (``tests/test_torch_ep.py``'s tolerances and worker).

C8: the decode wrappers take head dims 64 and 128 only; their checks raise
``ValueError`` naming the head dim before any CUDA call.
"""
import itertools
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
from d9d_tpu.parallel import fsdp_ep_plan as j_fsdp_ep_plan
from d9d_tpu_torch.core.collectives import copy_pairs, exchange_rows
from d9d_tpu_torch.core.mesh import MESH_AXIS_NAMES
from d9d_tpu_torch.model_state.from_jax import load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn.moe import LegacyPieces
from d9d_tpu_torch.ops.attention import decode
from test_torch_ep import MODEL, PARAM_TOL, STEP_TOL, WORKER
from test_torch_ring import scoped_jax_mesh, spawn  # noqa: F401 (autouse)

torch.set_num_threads(1)

MESH = dict(dp_replicate=3, dp_shard=2, ep_shard=2)
WORLD = 6
VOCAB, GBS, MBS, SEQ, LR, WD = 256, 12, 6, 32, 1e-2, 0.1
TRAIN = dict(global_batch_size=GBS, microbatch_size=MBS, seq_len=SEQ,
             total_steps=1, log_every=1, gc_every_steps=None)
KEYS = ("loss", "grad_norm", "loss_weight", "task/moe_load_max_frac")


def test_copy_pairs_name_no_row_twice():
    rows = np.random.default_rng(0).integers(0, 50, 400)
    pairs, copies = copy_pairs(rows)
    assert copies == np.bincount(rows).max()
    assert len(np.unique(pairs)) == len(pairs)
    np.testing.assert_array_equal(pairs // copies, rows)
    assert copy_pairs(np.arange(7))[1] == 1


def _dp_r3_pieces(rank):
    axes = ("dp_r", "dp_s")
    sizes = dict.fromkeys(MESH_AXIS_NAMES, 1)
    sizes.update(dp_r=3, dp_s=2)
    members = np.array(list(itertools.product(range(3), range(2))))
    return LegacyPieces(group=None, rank=rank, axes=axes, members=members,
                        sizes=sizes, batch_axes=axes, seq_axes=("cp_s",),
                        ep_axes=("dp_s",), dup_axes=())


@pytest.mark.parametrize("rank", range(WORLD))
def test_legacy_routes_at_dp_r3_gather_no_row_twice(rank):
    """Each of this rank's rows goes to the 3 ranks (one a dp_r replica)
    whose piece holds it: as 3 distinct pairs."""
    routes = _dp_r3_pieces(rank).routes(2, 8, "cpu")
    send = routes.send.numpy()
    assert routes.copies == 3
    assert len(np.unique(send)) == len(send) == 3 * 16
    np.testing.assert_array_equal(np.bincount(send // 3), [3] * 16)


def test_exchange_rows_gradient_is_the_gathers():
    """One rank (no collective): the values and the gradient of a gather by
    repeated rows, each row's copies summed in a fixed order."""
    rng = np.random.default_rng(1)
    rows = rng.permutation(np.repeat(np.arange(40), 3))
    pairs, copies = copy_pairs(rows)
    x = torch.tensor(rng.standard_normal((40, 8)), requires_grad=True)
    g = torch.tensor(rng.standard_normal((120, 8)))
    order = torch.tensor(rng.permutation(120))
    got = exchange_rows(x, torch.tensor(pairs), [120], [120], order, None,
                        copies=copies)
    got.backward(g)
    want_x = x.detach().clone().requires_grad_(True)
    want = want_x.index_select(0, torch.tensor(rows)).index_select(0, order)
    want.backward(g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, want_x.grad, rtol=1e-15, atol=1e-15)


# --- the legacy flow at dp_r 3 against JAX ------------------------------

class _JModel(JModelProvider):
    def __init__(self, ctx):
        self.ctx = ctx

    def build_module(self, stage):
        cfg = JQwen3MoeConfig(**MODEL, ep_axes=self.ctx.ep_shard_axes,
                              moe_token_axes=None)
        return JQwen3MoeCausalLM(config=cfg, sdpa=j_eager_sdpa, stage=stage,
                                 dtype=jnp.float32)

    def build_plan(self, ctx):
        return j_fsdp_ep_plan(ctx)

    def sample_inputs(self, batch_size, seq_len):
        z = jnp.zeros((batch_size, seq_len), jnp.int32)
        return (z, z, z)


class _JData(JDatasetProvider):
    def __init__(self, batches):
        self.batches = batches

    def build(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def dp_r3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_r3")
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, VOCAB, (GBS, SEQ + 1)),
                "loss_mask": (rng.random((GBS, SEQ + 1)) > 0.3).astype(
                    np.int32)}]
    jp = JMeshParameters(**MESH)
    jctx = jp.build(jax.devices()[:WORLD])
    jtr = JTrainer(
        ctx=jctx,
        config=JTrainerConfig(**TRAIN, telemetry_console=False,
                              prefetch_batches=0, handle_preemption=False),
        model_provider=_JModel(jctx), dataset_provider=_JData(batches),
        task=JCausalLMTask(),
        optimizer_provider=JAdamWProvider(weight_decay=WD), learning_rate=LR)
    weights = {k[len("params/"):]: np.asarray(v)
               for k, v in flatten_dict(jtr.params, sep="/").items()}
    arrays = {f"w/{k}": v for k, v in weights.items()}
    arrays.update(ids0=batches[0]["input_ids"], mask0=batches[0]["loss_mask"])
    np.savez(tmp / "run.npz", **arrays)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(dict(
        lr=LR, wd=WD, keys=KEYS, dispatch=[], capacities={}, experts=8,
        train=TRAIN, cases={"dp_r3_legacy": dict(mesh=MESH,
                                                 plan="fsdp_ep_legacy",
                                                 ring=None)},
        model=dict(MODEL, vocab_ranges=[list(r) for r in
                                        MODEL["vocab_ranges"]]))))
    sub = tmp / "spawn"
    sub.mkdir()
    wait = spawn(sub, WORKER, WORLD, spec, tmp / "run.npz", tmp / "out_")
    hist = jtr.train()
    final = {k[len("params/"):]: np.asarray(v)
             for k, v in flatten_dict(jtr.params, sep="/").items()}
    wait()
    ranks = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(WORLD)]
    return dict(ranks=ranks, hist={k: np.array([h[k] for h in hist])
                                   for k in KEYS}, final=final)


def test_legacy_flow_at_dp_r3_matches_jax(dp_r3):
    ranks, name = dp_r3["ranks"], "dp_r3_legacy"
    for r in ranks:
        for key in KEYS:
            np.testing.assert_array_equal(r[f"{name}/hist/{key}"],
                                          ranks[0][f"{name}/hist/{key}"])
    for key in KEYS[:3]:
        np.testing.assert_allclose(ranks[0][f"{name}/hist/{key}"],
                                   dp_r3["hist"][key], **STEP_TOL,
                                   err_msg=key)
    want = Qwen3MoeCausalLM(Qwen3MoeConfig(**MODEL), dtype=torch.float32,
                            device="cpu", seed=None)
    load_jax_params(want, dp_r3["final"])
    for pname, w in want.named_parameters():
        np.testing.assert_allclose(ranks[0][f"{name}/full/{pname}"],
                                   w.detach().numpy(), **PARAM_TOL,
                                   err_msg=pname)


# --- C8 -------------------------------------------------------------------

def _paged(d):
    q = torch.zeros(1, 1, 4, d)
    pool = torch.zeros(4, 2, 16, d)
    table = torch.zeros(1, 2, dtype=torch.int32)
    return q, pool, pool, table


@pytest.mark.parametrize("d", [32, 48])
def test_decode_checks_raise_at_unsupported_head_dims(d):
    with pytest.raises(ValueError, match=f"head_dim {d} is not supported by "
                                         f"the decode kernels"):
        decode._check_decode_head_dim("flash_decode", d)
    with pytest.raises(ValueError, match=f"flash_decode_paged: head_dim {d}"):
        decode._check_paged_inputs(*_paged(d), None, None)
    assert 32 not in decode.DECODE_HEAD_DIMS


@pytest.mark.parametrize("d", [64, 128])
def test_decode_checks_pass_the_kernels_head_dims(d):
    decode._check_decode_head_dim("flash_decode", d)
