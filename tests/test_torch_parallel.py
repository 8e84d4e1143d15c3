"""The mesh vocabulary, plans, sharded init, batch cutting and B10's index
offsets of the port's data-parallel slice, in one process (the runs over
processes are ``tests/test_torch_dp_train.py``):

- each parameter's logical axes in the port's layout are the JAX model's
  annotations (reversed for the transposed flax kernels), so the plans'
  rule tables pick the same dims on both sides;
- the mesh's axis groups and ``as_dict``/``from_dict`` are the JAX
  context's; ``tp_plan`` and ``with_tp=True`` carry the JAX tables and cut
  the dims JAX's tables map to tp and to the fsdp axes; the plan still to
  port (``fsdp_ep_plan``) raises naming its ROADMAP item;
- ``BatchMaths`` and ``stage_microbatches`` cut the rows and positions that
  JAX's ``batch_sharding`` places on the device at the same mesh
  coordinate;
- the meta-device build materialized by ``reset_parameters`` equals the
  one-process build bit for bit (the draw order of the sharded init; the
  sharded pieces themselves are checked in the gloo runs);
- B10's plain version at an index offset: any row range, any column
  range, and any block of both, of a ``[R, C]`` tensor rounds to the same
  bits as those elements of the whole tensor's rounding;
- ``set_seeds`` shifts Python's and numpy's seeds by ``pp_rank`` as the JAX
  function does;
- the host collectives return their input without a process group.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from d9d_tpu.core import MeshParameters as JMeshParameters
from d9d_tpu.core.determinism import set_seeds as j_set_seeds
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JQwen3DenseCausalLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JQwen3DenseConfig
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
from d9d_tpu.parallel import fsdp_plan as j_fsdp_plan
from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.core.collectives import (
    allgather_variadic,
    host_allgather_object,
    host_allreduce,
    host_allreduce_tree,
    host_broadcast_object,
)
from d9d_tpu_torch.core.determinism import MainProcessOnlyState, set_seeds
from d9d_tpu_torch.core.distributed import main_process_first
from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.loop import CausalLMTask
from d9d_tpu_torch.loop.components.batch_maths import BatchMaths
from d9d_tpu_torch.loop.components.batch_staging import stage_microbatches
from d9d_tpu_torch.loop.model_factory import materialize_
from d9d_tpu_torch.model_state.from_jax import jax_param_map, load_jax_params
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.nn.logical_axes import param_layouts
from d9d_tpu_torch.ops.stochastic import (
    shard_index,
    stochastic_round_to_bf16,
)
from d9d_tpu_torch.parallel import (
    fsdp_ep_plan,
    fsdp_plan,
    hsdp_plan,
    replicate_plan,
    tp_plan,
)
from d9d_tpu_torch.parallel.plan import shard_dims
from test_torch_ring import scoped_jax_mesh  # noqa: F401 (autouse)

CFG = dict(vocab_ranges=(("text", 40), ("special", 8)), hidden_size=32,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           intermediate_size=64, use_sinks=True, use_output_gate=True,
           remat=False)


def _port_model(device="cpu", seed=0, **kw):
    return Qwen3DenseCausalLM(Qwen3DenseConfig(**CFG), dtype=torch.float32,
                              device=device, seed=seed, **kw)


@pytest.fixture(scope="module")
def jax_logical():
    """The JAX model's flattened parameter names → logical axes."""
    jm = JQwen3DenseCausalLM(config=JQwen3DenseConfig(**CFG), sdpa=j_eager_sdpa,
                             dtype=jnp.float32)
    z = jnp.zeros((1, 8), jnp.int32)
    abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), z, z, z))
    specs = fnn.get_partition_spec(abstract)["params"]
    from flax.traverse_util import flatten_dict

    return {k: tuple(v) for k, v in flatten_dict(
        specs, sep="/", is_leaf=lambda _, x: isinstance(
            x, jax.sharding.PartitionSpec)).items()}


def test_param_axes_are_the_jax_annotations(jax_logical):
    model = _port_model()
    layouts = param_layouts(model)
    assert set(layouts) == {n for n, _ in model.named_parameters()}
    mapping = jax_param_map(model, jax_logical)
    for name, keys in mapping.items():
        want = jax_logical[keys[0]]
        if layouts[name].transposed:
            want = want[::-1]
        assert layouts[name].axes == want, name
    # the transposed ones are exactly the flax Dense kernels
    assert {n for n, lay in layouts.items() if lay.transposed} == {
        n for n, ks in mapping.items() if ks[0].endswith("/kernel")}


@pytest.mark.parametrize("mesh", [dict(dp_shard=2), dict(dp_shard=2,
                                                          cp_shard=2),
                                  dict(dp_replicate=2, dp_shard=2)])
def test_fsdp_shard_dims_follow_the_jax_plan(jax_logical, mesh):
    """The dim each port parameter shards on is the dim JAX's fsdp plan
    maps to the fsdp axes (after the transpose)."""
    jctx = JMeshParameters(**mesh).build(
        jax.devices()[:JMeshParameters(**mesh).world_size])
    ctx = MeshContext(params=MeshParameters(**mesh), device=torch.device("cpu"))
    model = _port_model()
    layouts = param_layouts(model)
    rules = dict(j_fsdp_plan(jctx).rules)
    assert dict(fsdp_plan(ctx).rules) == rules
    assert hsdp_plan(ctx).rules == fsdp_plan(ctx).rules
    dims = shard_dims(model, ctx, fsdp_plan(ctx))
    for name, keys in jax_param_map(model, jax_logical).items():
        spec = [rules.get(a) if a is not None else None
                for a in jax_logical[keys[0]]]
        if layouts[name].transposed:
            spec = spec[::-1]
        want = [d for d, m in enumerate(spec) if m]
        assert dims[name] == (want[0] if want else None), name
    assert shard_dims(model, ctx, replicate_plan(ctx)) == dict.fromkeys(dims)


def test_mesh_vocabulary_matches_jax():
    for kw in (dict(), dict(dp_replicate=2, dp_shard=2),
               dict(dp_shard=2, cp_shard=2, ep_shard=4),
               dict(dp_replicate=2, cp_shard=2, ep_shard=2)):
        jp = JMeshParameters(**kw)
        jctx = jp.build(jax.devices()[:jp.world_size])
        ctx = MeshContext(params=MeshParameters(**kw),
                          device=torch.device("cpu"))
        for attr in ("dp_axes", "cp_axes", "batch_axes", "sequence_axes",
                     "fsdp_axes", "grad_reduce_axes", "ep_shard_axes",
                     "ep_replicate_axes", "world_size", "pp_size"):
            assert getattr(ctx, attr) == getattr(jctx, attr), (kw, attr)
        for axes in (ctx.batch_axes, ctx.fsdp_axes, ctx.grad_reduce_axes):
            assert ctx.axis_size(*axes) == jctx.axis_size(*axes)
        assert ctx.params.as_dict() == jp.as_dict()
        assert MeshParameters.from_dict(jp.as_dict()) == ctx.params
    one = MeshParameters().build(["cpu"])
    assert (one.mesh, one.group("dp_s", "cp_s"), one.coordinate("dp_r")) == (
        None, None, 0)
    assert (one.process_index, one.process_count, one.is_main_process) == (
        0, 1, True)


def test_unported_plans_raise():
    """``fsdp_ep_plan`` (with and without tp) carries JAX's table rule for
    rule (``expert`` over the ep axes, the expert weights' feature dims
    whole), and the dims it cuts are JAX's: each expert weight's expert dim
    over the ep axes, no expert dim over tp or the fsdp axes."""
    from d9d_tpu.parallel import fsdp_ep_plan as j_fsdp_ep_plan
    from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
    from d9d_tpu_torch.parallel.plan import ep_dims, tp_dims

    for mesh in (dict(dp_replicate=2, dp_shard=2, ep_shard=2),
                 dict(dp_shard=2, tp=2, ep_shard=4)):
        with_tp = "tp" in mesh
        jctx = JMeshParameters(**mesh).build(
            jax.devices()[:JMeshParameters(**mesh).world_size])
        ctx = MeshContext(params=MeshParameters(**mesh),
                          device=torch.device("cpu"))
        port, ref = fsdp_ep_plan(ctx, with_tp=with_tp), j_fsdp_ep_plan(
            jctx, with_tp=with_tp)
        assert ctx.ep_shard_axes == jctx.ep_shard_axes
        assert ctx.ep_replicate_axes == jctx.ep_replicate_axes
        assert (port.name, port.rules) == (ref.name, ref.rules)
        model = Qwen3MoeCausalLM(dataclasses.replace(
            Qwen3MoeConfig.tiny(), ep_axes=ctx.ep_shard_axes), device="meta")
        cuts = {"ep": ep_dims(model, ctx, port),
                "fsdp": shard_dims(model, ctx, port),
                "tp": tp_dims(model, ctx, port) if with_tp else {}}
        experts = [n for n in cuts["ep"] if "grouped_experts" in n]
        assert len(experts) == 3 * Qwen3MoeConfig.tiny().num_layers
        for name, dim in cuts["ep"].items():
            assert dim == (0 if name in experts else None), name
        for name in experts:
            assert cuts["fsdp"][name] is None
            assert cuts["tp"].get(name) is None
        assert cuts["fsdp"]["model.layers.0.mlp.router.gate.weight"] == 1


@pytest.mark.parametrize("mesh", [dict(tp=2), dict(dp_shard=2, tp=2),
                                  dict(dp_replicate=2, cp_shard=2, tp=2)])
def test_tp_plans_follow_the_jax_plan(jax_logical, mesh):
    """``tp_plan`` and ``with_tp=True`` carry the JAX tables, and the dims
    each port parameter is cut on over tp and over the fsdp axes are the
    dims JAX's table maps to them (after the transpose)."""
    from d9d_tpu.parallel import hsdp_plan as j_hsdp_plan
    from d9d_tpu.parallel import tp_plan as j_tp_plan
    from d9d_tpu_torch.parallel.plan import tp_dims

    jctx = JMeshParameters(**mesh).build(
        jax.devices()[:JMeshParameters(**mesh).world_size])
    ctx = MeshContext(params=MeshParameters(**mesh), device=torch.device("cpu"))
    model = _port_model()
    layouts = param_layouts(model)
    for port, ref in ((tp_plan(ctx), j_tp_plan(jctx)),
                      (fsdp_plan(ctx, with_tp=True),
                       j_fsdp_plan(jctx, with_tp=True)),
                      (hsdp_plan(ctx, with_tp=True),
                       j_hsdp_plan(jctx, with_tp=True))):
        rules = dict(ref.rules)
        assert (port.name, port.rules) == (ref.name, ref.rules)
        cuts = {"tp": tp_dims(model, ctx, port),
                "fsdp": shard_dims(model, ctx, port)}
        for name, keys in jax_param_map(model, jax_logical).items():
            spec = [rules.get(a) if a is not None else None
                    for a in jax_logical[keys[0]]]
            if layouts[name].transposed:
                spec = spec[::-1]
            axes = [(m,) if isinstance(m, str) else tuple(m or ())
                    for m in spec]
            want_tp = [d for d, a in enumerate(axes) if "tp" in a]
            want_fsdp = [d for d, a in enumerate(axes)
                         if set(a) - {"tp"}]
            assert cuts["tp"][name] == (want_tp or [None])[0], (port, name)
            assert cuts["fsdp"][name] == (want_fsdp or [None])[0], (port,
                                                                    name)
        # the vocab tables: tp major, then the fsdp axes, on one dim
        assert dict(port.rules)["vocab"] in ("tp", ("tp",) + ctx.fsdp_axes)


def test_batch_cut_matches_jax_batch_sharding():
    """Each device's rows and positions under JAX's batch_sharding are the
    port's cut at the same (dp_r, dp_s, cp_s) coordinate."""
    mesh = dict(dp_replicate=2, dp_shard=2, cp_shard=2)
    jctx = JMeshParameters(**mesh).build(jax.devices()[:8])
    n, m, t = 2, 8, 12
    maths = BatchMaths.from_context(
        MeshContext(params=MeshParameters(**mesh), device=torch.device("cpu")),
        n * m, m)
    assert (maths.dp_size, maths.num_microbatches) == (4, n)
    with pytest.raises(ValueError, match="not divisible by dp_size"):
        BatchMaths(global_batch_size=12, microbatch_size=6, dp_size=4)
    ids = np.arange(n * m * (t + 1)).reshape(n * m, t + 1)
    prepared = CausalLMTask().prepare_batch({"input_ids": ids})
    devices = list(jctx.mesh.devices.flat)
    for i in range(n):
        rows = slice(i * m, (i + 1) * m)
        placed = jax.device_put(prepared["tokens"][rows],
                                jctx.batch_sharding())
        by_device = {s.device: np.asarray(s.data)
                     for s in placed.addressable_shards}
        for rank, device in enumerate(devices):
            dp_rank, cp_rank = divmod(rank, 2)  # row-major (dp_r, dp_s, cp_s)
            got = stage_microbatches(
                prepared, num_microbatches=n, microbatch_size=m,
                device=torch.device("cpu"), seq_len=t, cp_size=2,
                cp_rank=cp_rank, dp_size=4, dp_rank=dp_rank)[i]
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          by_device[device])
            lo = cp_rank * t // 2
            np.testing.assert_array_equal(got["positions"][0].numpy(),
                                          np.arange(lo, lo + t // 2))


def test_meta_build_materializes_to_the_one_process_build():
    """The sharded init's draw order: a meta build, materialized by every
    module's reset_parameters from the model's seed, equals the direct
    build bit for bit (bf16 parameters too), buffers included."""
    for param_dtype in (torch.float32, torch.bfloat16):
        want = _port_model(seed=7, param_dtype=param_dtype)
        got = _port_model(device="meta", seed=7, param_dtype=param_dtype)
        assert all(p.is_meta for p in got.parameters())
        with pytest.raises(ValueError, match="meta device"):
            load_jax_params(got, {})
        materialize_(got, torch.device("cpu"), got.seed)
        for (name, a), (_, b) in zip(want.state_dict().items(),
                                     got.state_dict().items()):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        for a, b in zip(want.buffers(), got.buffers()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(24, 40), (7, 9), (3, 5, 12)])
def test_stochastic_round_pieces_match_the_whole(shape):
    """B10's plain version on a piece at its index offset: the bits of the
    same elements of the whole tensor's rounding, for row ranges (dim 0),
    column ranges (a later dim, one run per row) and FSDP's chunks."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen) * 3.0
    seed = 0x1234_5678_9ABC_DEF0
    whole = stochastic_round_to_bf16(x, seed).view(torch.int16)
    for dim in range(len(shape)):
        n = shape[dim]
        ranges = [(a, b) for a in range(n) for b in range(a + 1, n + 1)]
        for size in (2, 3, 4):  # FSDP's torch.chunk pieces
            chunk = -(-n // size)
            ranges += [(min(r * chunk, n), min((r + 1) * chunk, n))
                       for r in range(size)]
        for a, b in ranges:
            piece = x.narrow(dim, a, b - a).contiguous()
            offset, cols, row_stride = shard_index(shape, [(dim, a, b - a)])
            got = stochastic_round_to_bf16(
                piece, seed, index_offset=offset, cols=cols,
                row_stride=row_stride).view(torch.int16)
            want = whole.narrow(dim, a, b - a)
            assert torch.equal(got, want), (dim, a, b)
    # without its offset a piece draws other bits
    piece = x.narrow(0, 1, shape[0] - 1).contiguous()
    assert not torch.equal(stochastic_round_to_bf16(piece, seed).view(
        torch.int16), whole[1:])
    with pytest.raises(ValueError, match="do not place"):
        stochastic_round_to_bf16(x, seed, cols=x.numel() + 1)


@pytest.mark.parametrize("shape", [(24, 40), (7, 9), (3, 5, 12)])
def test_stochastic_round_blocks_match_the_whole(shape):
    """B10's plain version on a block (rows of dim 0 cut by tensor
    parallelism, a range of a later dim cut by FSDP) at ``shard_index``'s
    offsets: the bits of the same elements of the whole tensor's
    rounding. A cut on two dims past dim 0 raises."""
    gen = torch.Generator().manual_seed(sum(shape) + 1)
    x = torch.randn(shape, generator=gen) * 3.0
    seed = 0x0FED_CBA9_8765_4321
    whole = stochastic_round_to_bf16(x, seed).view(torch.int16)
    for dim in range(1, len(shape)):
        for r0, r1 in ((0, 1), (1, shape[0]), (shape[0] // 2, shape[0])):
            for c0, c1 in ((0, shape[dim] // 2), (1, shape[dim] - 1)):
                bounds = [(0, r0, r1 - r0), (dim, c0, c1 - c0)]
                piece = x[r0:r1].narrow(dim, c0, c1 - c0).contiguous()
                offset, cols, row_stride = shard_index(shape, bounds)
                got = stochastic_round_to_bf16(
                    piece, seed, index_offset=offset, cols=cols,
                    row_stride=row_stride).view(torch.int16)
                want = whole[r0:r1].narrow(dim, c0, c1 - c0)
                assert torch.equal(got, want), bounds
    if len(shape) == 3:
        with pytest.raises(ValueError, match="dims other than dim 0"):
            shard_index(shape, [(1, 0, 2), (2, 0, 6)])


def test_set_seeds_shifts_by_pipeline_stage():
    for pp_rank in (0, 1, 3):
        j_set_seeds(11, pp_rank=pp_rank)
        want = (random.random(), np.random.random())
        gen = set_seeds(11, pp_rank=pp_rank)
        assert (random.random(), np.random.random()) == want
        ref = torch.Generator().manual_seed(11 + pp_rank)
        assert torch.equal(torch.rand(4, generator=gen),
                           torch.rand(4, generator=ref))
    assert not torch.equal(torch.rand(4, generator=set_seeds(11)),
                           torch.rand(4, generator=set_seeds(11, pp_rank=1)))


def test_host_collectives_without_a_group_return_their_input():
    x = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(host_allreduce(x), x)
    tree = host_allreduce_tree({"a": x, "b": [x, x]})
    np.testing.assert_array_equal(tree["b"][1], x)
    assert host_allgather_object({"k": 1}) == [{"k": 1}]
    assert host_broadcast_object("hello") == "hello"
    (got,) = allgather_variadic(x)
    np.testing.assert_array_equal(got, x)
    ran = []
    with main_process_first():
        ran.append(1)
    assert ran == [1]

    class Counter:
        def __init__(self):
            self.n = 3

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, state):
            self.n = state["n"]

    wrapped = MainProcessOnlyState(Counter())
    assert wrapped.state_dict() == {"state": {"n": 3}}
    wrapped.load_state_dict({"state": {"n": 5}})
    assert wrapped.inner.n == 5
