"""The port's model state (``d9d_tpu_torch/model_state/``) against the JAX
package's (``d9d_tpu/model_state/``), at tiny sizes on the CPU:

- every mapper leaf and composition gives the JAX mapper's group set and,
  group by group, its outputs bit for bit on the same seeded state;
- the port's safetensors files (``io/safetensors_format.py``, torch and
  json alone) read back through the ``safetensors`` package and the
  package's files through the port, for every dtype it writes, BF16
  included; the two writers' files are the same bytes;
- the Qwen3 HF mappers: tiny dense and MoE weights carried from JAX by
  ``load_jax_params`` export through the port to the same keys and the
  same tensors (the same files) as JAX's ``save_params`` through its HF
  mappers; JAX's ``read_model_state`` reads the port's export and the
  port reads JAX's; the port loads JAX's export and gives JAX's logits
  within 1e-5, for transformers v4 and fused v5 experts;
- sharded models in 4 gloo processes (``dp_shard 2 x tp 2`` dense under
  ``fsdp_plan(with_tp=True)`` and MoE with ``ep_shard 4`` under
  ``fsdp_ep_plan(with_tp=True)``; ``dp_replicate 2 x dp_shard 2,
  ep_shard 2`` MoE): ``Trainer.export`` writes the one-process export bit
  for bit, and ``load_params`` gives every rank the piece ``local_piece``
  gives, through the HF mapper (whole tensors) and the identity mapper
  (each rank reading its rows).
"""
import json

import numpy as np
import pytest
import safetensors.torch as st
import torch

import jax
import jax.numpy as jnp
from flax.core import meta as flax_meta
from flax.traverse_util import flatten_dict

import d9d_tpu.model_state.mapper as J
from d9d_tpu.model_state.io import load_params as j_load_params
from d9d_tpu.model_state.io import read_model_state as j_read_model_state
from d9d_tpu.model_state.io import save_params as j_save_params
from d9d_tpu.model_state.io.module import (
    identity_mapper_from_names as j_identity_mapper,
)
from d9d_tpu.models.qwen3 import Qwen3DenseCausalLM as JQwen3DenseCausalLM
from d9d_tpu.models.qwen3 import Qwen3DenseConfig as JQwen3DenseConfig
from d9d_tpu.models.qwen3 import Qwen3MoeCausalLM as JQwen3MoeCausalLM
from d9d_tpu.models.qwen3 import Qwen3MoeConfig as JQwen3MoeConfig
from d9d_tpu.models.qwen3 import huggingface as jhf
from d9d_tpu.ops.attention.eager import eager_sdpa as j_eager_sdpa
import d9d_tpu_torch.model_state.mapper as T
from d9d_tpu_torch.model_state import (
    identity_mapper_from_names,
    load_jax_params,
    load_params,
    read_index,
    read_model_state,
    save_params,
)
from d9d_tpu_torch.model_state.io import safetensors_format as fmt
from d9d_tpu_torch.model_state.io.writer import (
    write_model_state_pipeline_parallel,
)
from d9d_tpu_torch.models.qwen3 import (
    Qwen3DenseCausalLM,
    Qwen3DenseConfig,
    Qwen3MoeCausalLM,
    Qwen3MoeConfig,
)
from d9d_tpu_torch.models.qwen3 import huggingface as thf
from test_torch_ring import spawn

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
SHARD = "model-00001-of-00001.safetensors"


def _state():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"a": f(3, 4), "b": f(3, 4), "c": f(3, 4), "d": f(2, 5),
            "s": f(1, 4, 1), "st": f(3, 2, 5), "ch": f(7, 3),
            "parent.x": f(2, 2), "parent.y": f(3), "src.a": f(3, 4),
            "src.b": f(3, 4), "src.c": f(3, 4)}


# name → builder(mapper module, float16 of that side)
MAPPERS = {
    "identity": lambda M, h: M.ModelStateMapperIdentity("a"),
    "rename": lambda M, h: M.ModelStateMapperRename("a", "z"),
    "transpose": lambda M, h: M.ModelStateMapperTranspose("st", (0, 2)),
    "squeeze_all": lambda M, h: M.ModelStateMapperSqueeze("s"),
    "squeeze_dim": lambda M, h: M.ModelStateMapperSqueeze("s", 2),
    "unsqueeze": lambda M, h: M.ModelStateMapperUnsqueeze("a", 1),
    "cast": lambda M, h: M.ModelStateMapperCast("a", h),
    "stack": lambda M, h: M.ModelStateMapperStackTensors(["a", "b"], "z", 1),
    "unstack": lambda M, h: M.ModelStateMapperUnstackTensors(
        "st", ["u0", "u1"], 1),
    "chunk": lambda M, h: M.ModelStateMapperChunkTensors(
        "ch", ["c0", "c1", "c2"], 0),
    "concat": lambda M, h: M.ModelStateMapperConcatenateTensors(
        ["a", "b"], "z", 1),
    "select_child": lambda M, h: M.ModelStateMapperSelectChildModules(
        ["x", "y"], "parent"),
    "parallel": lambda M, h: M.ModelStateMapperParallel([
        M.ModelStateMapperRename("a", "z"),
        M.ModelStateMapperStackTensors(["b", "c"], "w", 0),
        M.ModelStateMapperIdentity("d")]),
    # b passes stage 0, e is made in stage 0 and never consumed again, and
    # {a, b} → {w} merges across the stages
    "sequential": lambda M, h: M.ModelStateMapperSequential([
        M.ModelStateMapperParallel([M.ModelStateMapperRename("a", "z"),
                                    M.ModelStateMapperRename("d", "e")]),
        M.ModelStateMapperStackTensors(["z", "b"], "w", 0),
        M.ModelStateMapperTranspose("w", (1, 2))]),
    "prefix": lambda M, h: M.ModelStateMapperPrefixScope(
        M.ModelStateMapperParallel([
            M.ModelStateMapperRename("a", "z"),
            M.ModelStateMapperStackTensors(["b", "c"], "w", 0)]),
        "src.", "dst."),
    "shard": lambda M, h: M.ModelStateMapperShard(
        M.ModelStateMapperParallel([M.ModelStateMapperIdentity(k)
                                    for k in "abcd"]), 3, 1),
}


def _groups(mapper):
    return {(g.inputs, g.outputs) for g in mapper.state_dependency_groups()}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", list(MAPPERS))
def test_mapper_matches_jax(name):
    state = _state()
    jm = MAPPERS[name](J, np.float16)
    tm = MAPPERS[name](T, torch.float16)
    assert _groups(tm) == _groups(jm)
    assert _groups(tm)
    for inputs, outputs in _groups(jm):
        want = jm.apply({k: state[k] for k in inputs})
        got = tm.apply({k: torch.from_numpy(state[k].copy()) for k in inputs})
        assert set(got) == set(want) == set(outputs)
        for k in want:
            assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=f"{name}: {k}")


def test_mapper_errors_match_jax():
    """The refusals of both packages: keys claimed twice in a parallel
    mapper, a key consumed before a later stage needs it, an unstack of
    the wrong size, a sequence of empty stages."""
    for M in (J, T):
        with pytest.raises(ValueError, match="claimed by more than one"):
            M.ModelStateMapperParallel([M.ModelStateMapperIdentity("a"),
                                        M.ModelStateMapperRename("a", "b")])
        with pytest.raises(ValueError, match="later stages still need"):
            M.ModelStateMapperSequential([
                M.ModelStateMapperRename("a", "b"),
                M.ModelStateMapperIdentity("a")])
        with pytest.raises(ValueError, match="at least one stage"):
            M.ModelStateMapperSequential([M.ModelStateMapperParallel([])])
        assert len(M.filter_empty_mappers(
            [M.ModelStateMapperParallel([]),
             M.ModelStateMapperIdentity("a")])) == 1
    with pytest.raises(ValueError, match="cannot unstack"):
        T.ModelStateMapperUnstackTensors("st", ["u0"], 1).apply(
            {"st": torch.zeros(3, 2, 5)})


DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16,
          "F16": torch.float16, "I64": torch.int64, "I32": torch.int32,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _tensors(dtype):
    g = torch.Generator().manual_seed(7)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    elif dtype == torch.bool:
        make = lambda *s: torch.rand(s, generator=g) > 0.5  # noqa: E731
    else:
        lo = 0 if dtype == torch.uint8 else -100
        make = lambda *s: torch.randint(  # noqa: E731
            lo, 100, s, generator=g).to(dtype)
    return {"w": make(5, 3, 2), "v": make(7), "scalar": make(), "empty":
            make(0, 4), "b.a": make(2, 9)}


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_format_against_the_package(name, tmp_path):
    dtype = DTYPES[name]
    tensors = _tensors(dtype)
    fmt.save_file(tensors, tmp_path / "port.safetensors")
    st.save_file(tensors, tmp_path / "package.safetensors")
    assert (tmp_path / "port.safetensors").read_bytes() == (
        tmp_path / "package.safetensors").read_bytes()
    theirs = st.load_file(tmp_path / "port.safetensors")
    ours = fmt.load_file(tmp_path / "package.safetensors")
    for k, t in tensors.items():
        for got in (theirs[k], ours[k]):
            assert got.dtype == dtype and got.shape == t.shape, k
            assert torch.equal(got, t), k
    with fmt.SafetensorsFile(tmp_path / "package.safetensors") as f:
        assert f.dtype("w") == dtype and f.shape("w") == (5, 3, 2)
        assert torch.equal(f.get_rows("w", 1, 4), tensors["w"][1:4])
        assert f.get_rows("w", 2, 2).shape == (0, 3, 2)
        with pytest.raises(IndexError):
            f.get_rows("w", 3, 6)


def test_safetensors_format_metadata_and_refusals(tmp_path):
    """The package's files carry ``__metadata__`` (HF's ``{"format":
    "pt"}``): the port reads past it; a dtype outside the list raises."""
    st.save_file({"x": torch.ones(2)}, tmp_path / "m.safetensors",
                 metadata={"format": "pt"})
    with fmt.SafetensorsFile(tmp_path / "m.safetensors") as f:
        assert f.keys() == ["x"] and torch.equal(f.get_tensor("x"),
                                                 torch.ones(2))
    with pytest.raises(ValueError, match="no safetensors name"):
        fmt.save_file({"x": torch.ones(2, dtype=torch.complex64)},
                      tmp_path / "c.safetensors")


# --- the Qwen3 HF mappers against JAX's ---------------------------------

DENSE = dict(vocab_ranges=(("default", 200), ("extra", 56)), hidden_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             intermediate_size=96, remat=False)
MOE = dict(vocab_ranges=(("default", 200), ("extra", 56)), hidden_size=64,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
           moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
           intermediate_size=96, mlp_only_layers=(1,), remat=False)
# name: JAX class and config, port class and config, mapper pair, kwargs
FAMILIES = {
    "dense": (JQwen3DenseCausalLM, JQwen3DenseConfig, Qwen3DenseCausalLM,
              Qwen3DenseConfig, "qwen3_dense", DENSE, {}),
    "dense_tied": (JQwen3DenseCausalLM, JQwen3DenseConfig, Qwen3DenseCausalLM,
                   Qwen3DenseConfig, "qwen3_dense", DENSE,
                   dict(tie_word_embeddings=True)),
    "moe_v4": (JQwen3MoeCausalLM, JQwen3MoeConfig, Qwen3MoeCausalLM,
               Qwen3MoeConfig, "qwen3_moe", MOE,
               dict(experts_format="module_list")),
    "moe_v5": (JQwen3MoeCausalLM, JQwen3MoeConfig, Qwen3MoeCausalLM,
               Qwen3MoeConfig, "qwen3_moe", MOE,
               dict(experts_format="fused")),
}


def _tokens():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    return ids, pos


def _family(name):
    jcls, jcfg_cls, tcls, tcfg_cls, prefix, kw, mkw = FAMILIES[name]
    jcfg, tcfg = jcfg_cls(**kw), tcfg_cls(**kw)
    jm = jcls(config=jcfg, sdpa=j_eager_sdpa, dtype=jnp.float32)
    ids, pos = (jnp.asarray(a) for a in _tokens())
    params = {"params": flax_meta.unbox(
        jm.init(jax.random.PRNGKey(1), ids, pos, ids))["params"]}
    if mkw.get("tie_word_embeddings"):
        # tied: one table, as an HF checkpoint holds it
        p = params["params"]
        for n, _ in jcfg.vocab_ranges:
            p["lm_head"][f"head_{n}"] = p["model"]["embed_tokens"][
                f"embedding_{n}"]
    tm = tcls(tcfg, dtype=torch.float32, device="cpu", seed=None)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         flatten_dict(params["params"], sep="/").items()})
    to_hf, from_hf = ({"jax": getattr(jhf, f"{prefix}_{way}_hf_mapper")(
        jcfg, **mkw), "port": getattr(thf, f"{prefix}_{way}_hf_mapper")(
        tcfg, **mkw)} for way in ("to", "from"))
    return jm, params, tm, tcfg, to_hf, from_hf


@pytest.mark.parametrize("name", list(FAMILIES))
def test_hf_export_and_load_match_jax(name, tmp_path):
    jm, params, tm, tcfg, to_hf, from_hf = _family(name)
    # the HF side of every group is JAX's
    for way, side in ((from_hf, 0), (to_hf, 1)):
        assert {g[side] for g in _groups(way["port"])} == {
            g[side] for g in _groups(way["jax"])}
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_save_params(jdir, params, mapper=to_hf["jax"])
    save_params(tdir, tm, mapper=to_hf["port"])
    # the same index, the same tensors under the same HF names: the same
    # file
    assert json.loads((jdir / "model.safetensors.index.json").read_text()) \
        == json.loads((tdir / "model.safetensors.index.json").read_text())
    want, got = st.load_file(jdir / SHARD), st.load_file(tdir / SHARD)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert (jdir / SHARD).read_bytes() == (tdir / SHARD).read_bytes()
    if "tied" in name:
        assert "lm_head.weight" not in got

    # each package reads the other's export
    theirs = dict(j_read_model_state(tdir, j_identity_mapper(want)))
    ours = dict(read_model_state(jdir, identity_mapper_from_names(want)))
    for k in want:
        np.testing.assert_array_equal(np.asarray(theirs[k]), want[k].numpy())
        assert torch.equal(ours[k], want[k])
    assert read_index(jdir).weight_map == {k: SHARD for k in want}

    # the port loads JAX's export and gives JAX's logits
    ids, pos = _tokens()
    template = jax.tree.map(np.zeros_like, params)
    jloaded = j_load_params(jdir, template, mapper=from_hf["jax"])
    jlogits = np.asarray(jm.apply(jloaded, jnp.asarray(ids), jnp.asarray(pos),
                                  method=jm.logits))
    fresh = type(tm)(tcfg, dtype=torch.float32, device="cpu", seed=5)
    load_params(jdir, fresh, mapper=from_hf["port"])
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(p, q), n
    logits = fresh.logits(torch.from_numpy(ids).long(),
                          torch.from_numpy(pos).long())
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               **LOGITS_TOL)


def test_load_errors_match_jax(tmp_path):
    """A parameter the checkpoint lacks, a shape that differs, an output
    the model lacks: JAX's errors; the pipeline writer, given a stream that
    leaves a mapper group without its inputs, raises as the others do."""
    cfg = Qwen3DenseConfig.tiny(32)
    model = Qwen3DenseCausalLM(cfg, dtype=torch.float32, device="cpu", seed=0)
    save_params(tmp_path / "all", model)
    named = dict(model.named_parameters())
    short = {k: v for k, v in named.items() if k != "model.norm.weight"}
    save_params(tmp_path / "short", short)
    with pytest.raises(ValueError, match="states \\['model.norm.weight'\\] "
                                         "are missing"):
        load_params(tmp_path / "short", model)
    with pytest.raises(ValueError, match="checkpoint missing params"):
        load_params(tmp_path / "short", model,
                    mapper=identity_mapper_from_names(short))
    wide = Qwen3DenseCausalLM(Qwen3DenseConfig.tiny(64), dtype=torch.float32,
                              device="cpu", seed=0)
    with pytest.raises(ValueError, match=r"shape mismatch for lm_head.weight:"
                                         r" checkpoint \(32, 64\) vs "
                                         r"template \(64, 64\)"):
        load_params(tmp_path / "all", wide)
    extra = T.ModelStateMapperParallel(
        [T.ModelStateMapperRename("model.norm.weight", "model.nope")])
    with pytest.raises(KeyError, match="unknown param 'model.nope'"):
        load_params(tmp_path / "all", model, mapper=extra)
    with pytest.raises(ValueError, match="still waiting for inputs"):
        write_model_state_pipeline_parallel(tmp_path, extra, iter(()), 0,
                                            True)


# --- sharded models in 4 gloo processes ---------------------------------

MESH_CASES = {
    "dp_tp_dense": (dict(dp_shard=2, tp=2), "dense", "fsdp_tp"),
    "dp_tp_moe": (dict(dp_shard=2, tp=2, ep_shard=4), "moe", "fsdp_ep_tp"),
    "hsdp_ep_moe": (dict(dp_replicate=2, dp_shard=2, ep_shard=2), "moe",
                    "fsdp_ep"),
}
# vocab 250: tp 2 cuts it into 125 rows, dp_s 2 those into 63 and 62
MESH_VOCAB = 250

WORKER = r'''
import sys

import torch

from d9d_tpu_torch.core import MeshParameters, init_distributed, shutdown_distributed
from d9d_tpu_torch.loop import (AdamWProvider, CausalLMTask, DatasetProvider,
                                ModelProvider, Trainer, TrainerConfig)
from d9d_tpu_torch.model_state import load_params
from d9d_tpu_torch.model_state.io.safetensors_format import load_file
from d9d_tpu_torch.models.qwen3 import (Qwen3DenseCausalLM, Qwen3DenseConfig,
                                        Qwen3MoeCausalLM, Qwen3MoeConfig)
from d9d_tpu_torch.models.qwen3 import huggingface as hf
from d9d_tpu_torch.parallel import fsdp_ep_plan, fsdp_plan
from d9d_tpu_torch.parallel.shards import is_sharded, local_piece, local_tensor

torch.set_num_threads(1)
rank, world, rdzv, tmp = sys.argv[1:5]
rank, world = int(rank), int(world)
assert init_distributed(rank=rank, world_size=world, init_method=rdzv,
                        backend="gloo")
CASES = __CASES__
VOCAB = __VOCAB__
PLANS = {"fsdp_tp": lambda c: fsdp_plan(c, with_tp=True),
         "fsdp_ep": fsdp_ep_plan,
         "fsdp_ep_tp": lambda c: fsdp_ep_plan(c, with_tp=True)}


def config(family, c):
    if family == "dense":
        return Qwen3DenseConfig.tiny(VOCAB)
    return Qwen3MoeConfig.tiny(VOCAB, ep_axes=c.ep_shard_axes)


def trainer(mesh, family, plan, seed):
    ctx = MeshParameters(**mesh).build(["cpu"] * world)

    class Model(ModelProvider):
        def build_module(self, c):
            cls = Qwen3DenseCausalLM if family == "dense" else Qwen3MoeCausalLM
            return cls(config(family, c), dtype=torch.float32,
                       device=c.device, seed=seed)

        def build_plan(self, c):
            return PLANS[plan](c)

    class Data(DatasetProvider):
        def build(self):
            return iter(())

    return ctx, Trainer(
        ctx=ctx, config=TrainerConfig(global_batch_size=4, microbatch_size=4,
                                      seq_len=8, total_steps=1),
        model_provider=Model(), dataset_provider=Data(), task=CausalLMTask(),
        optimizer_provider=AdamWProvider())


lines = []
for name, (mesh, family, plan) in CASES.items():
    ctx, tr = trainer(mesh, family, plan, seed=0)
    sharded = sum(is_sharded(p) for p in tr.module.parameters())
    mapper = getattr(hf, f"qwen3_{family}_to_hf_mapper")
    tr.export(f"{tmp}/{name}_hf", mapper=mapper(config(family, ctx)))
    tr.export(f"{tmp}/{name}_id")
    del tr
    # another model's weights, then each one-process export loaded onto it
    whole = load_file(f"{tmp}/one_{family}_id/model-00001-of-00001.safetensors")
    for how in ("hf", "id"):
        _, other = trainer(mesh, family, plan, seed=1)
        back = getattr(hf, f"qwen3_{family}_from_hf_mapper")(config(family,
                                                                    ctx))
        load_params(f"{tmp}/one_{family}_{how}", other.module,
                    mapper=back if how == "hf" else None)
        for pname, p in other.module.named_parameters():
            want = local_piece(whole[pname], p)
            got = local_tensor(p.detach())
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{name} {how} rank {rank}: {pname}")
        del other
    lines.append(f"{name} sharded={sharded}")
open(f"{tmp}/rank{rank}.txt", "w").write("\n".join(lines))
assert "jax" not in sys.modules
shutdown_distributed()
'''


def _one_process(family):
    cls, cfg = ((Qwen3DenseCausalLM, Qwen3DenseConfig.tiny(MESH_VOCAB))
                if family == "dense" else
                (Qwen3MoeCausalLM, Qwen3MoeConfig.tiny(MESH_VOCAB)))
    return cls(cfg, dtype=torch.float32, device="cpu", seed=0), cfg


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_state_mesh")
    for family in ("dense", "moe"):
        model, cfg = _one_process(family)
        mapper = getattr(thf, f"qwen3_{family}_to_hf_mapper")(cfg)
        save_params(tmp / f"one_{family}_hf", model, mapper=mapper)
        save_params(tmp / f"one_{family}_id", model)
    source = WORKER.replace("__CASES__", repr(MESH_CASES)).replace(
        "__VOCAB__", str(MESH_VOCAB))
    spawn(tmp, source, 4, tmp)()
    return tmp


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_sharded_export_and_load(mesh_runs, name):
    """The export from the mesh is the one-process export, file for file;
    every rank held sharded parameters; every rank's pieces after a load
    are ``local_piece`` of the whole (the worker checks them)."""
    family = MESH_CASES[name][1]
    for how in ("hf", "id"):
        one, got = mesh_runs / f"one_{family}_{how}", mesh_runs / f"{name}_{how}"
        assert sorted(p.name for p in got.iterdir()) == sorted(
            p.name for p in one.iterdir())
        for f in one.iterdir():
            assert (got / f.name).read_bytes() == f.read_bytes(), (how, f.name)
    for r in range(4):
        lines = (mesh_runs / f"rank{r}.txt").read_text().splitlines()
        sharded = dict(line.split(" ") for line in lines)[name]
        assert int(sharded.split("=")[1]) > 0
