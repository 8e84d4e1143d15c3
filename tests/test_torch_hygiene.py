"""Package hygiene of the PyTorch port: what it may import, and that a
kernel wrapper never falls back to its plain version for a tensor that does
not lie on the CPU."""
import ast
import pathlib

import pytest
import torch

import d9d_tpu_torch
from d9d_tpu_torch.ops import kernel_lib
from d9d_tpu_torch.ops.attention import decode as tdec
from d9d_tpu_torch.ops.attention import flash as tflash
from d9d_tpu_torch.ops import moe as tmoe
from d9d_tpu_torch.ops import moe_ffn as tmf

torch.set_num_threads(1)

ROOT = pathlib.Path(d9d_tpu_torch.__file__).resolve().parent.parent
# the card's machine holds neither safetensors nor pydantic: the port reads
# and writes the format itself (model_state/io/safetensors_format.py)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "d9d_tpu",
             "safetensors", "pydantic"}
LAZY_ONLY = {"triton"}


def _port_files():
    files = sorted((ROOT / "d9d_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(top-level package, node is at module level) of every import."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def at_module_level(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return False
        return True

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], at_module_level(node)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], at_module_level(node)


def test_port_has_the_expected_files():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in (
        "chip_smoke.py",
        "d9d_tpu_torch/ops/attention/flash.py",
        "d9d_tpu_torch/ops/attention/decode.py",
        "d9d_tpu_torch/loop/generate.py",
        "d9d_tpu_torch/loop/serve.py",
        "d9d_tpu_torch/model_state/from_jax.py",
        "d9d_tpu_torch/ops/linear_ce.py",
        "d9d_tpu_torch/core/mesh.py",
        "d9d_tpu_torch/nn/init.py",
        "d9d_tpu_torch/optim/adamw.py",
        "d9d_tpu_torch/lr_scheduler/builder.py",
        "d9d_tpu_torch/lr_scheduler/config.py",
        "d9d_tpu_torch/lr_scheduler/curves.py",
        "d9d_tpu_torch/lr_scheduler/engine.py",
        "d9d_tpu_torch/loop/auto.py",
        "d9d_tpu_torch/loop/config.py",
        "d9d_tpu_torch/loop/tasks.py",
        "d9d_tpu_torch/loop/train.py",
        "d9d_tpu_torch/loop/train_step.py",
        "d9d_tpu_torch/loop/control/task.py",
        "d9d_tpu_torch/loop/control/providers.py",
        "d9d_tpu_torch/loop/components/batch_maths.py",
        "d9d_tpu_torch/loop/components/batch_staging.py",
        "d9d_tpu_torch/loop/components/garbage_collector.py",
        "d9d_tpu_torch/loop/components/metric_collector.py",
        "d9d_tpu_torch/loop/components/stepper.py",
        "d9d_tpu_torch/tracker/base.py",
        "d9d_tpu_torch/tracker/providers.py",
        "d9d_tpu_torch/ops/moe.py",
        "d9d_tpu_torch/ops/moe_ffn.py",
        "d9d_tpu_torch/nn/moe.py",
        "d9d_tpu_torch/models/qwen3/moe.py",
        "d9d_tpu_torch/loop/kv_paging.py",
        "d9d_tpu_torch/nn/decode_flags.py",
        "d9d_tpu_torch/ops/stochastic.py",
        "d9d_tpu_torch/optim/stochastic_adamw.py",
        "d9d_tpu_torch/ops/attention/ring.py",
        "d9d_tpu_torch/core/distributed.py",
        "d9d_tpu_torch/core/collectives.py",
        "d9d_tpu_torch/core/determinism.py",
        "d9d_tpu_torch/nn/logical_axes.py",
        "d9d_tpu_torch/parallel/plan.py",
        "d9d_tpu_torch/parallel/shards.py",
        "d9d_tpu_torch/loop/model_factory.py",
        "d9d_tpu_torch/model_state/mapper/abc.py",
        "d9d_tpu_torch/model_state/mapper/leaf.py",
        "d9d_tpu_torch/model_state/mapper/compose.py",
        "d9d_tpu_torch/model_state/io/dto.py",
        "d9d_tpu_torch/model_state/io/module.py",
        "d9d_tpu_torch/model_state/io/reader.py",
        "d9d_tpu_torch/model_state/io/safetensors_format.py",
        "d9d_tpu_torch/model_state/io/writer.py",
        "d9d_tpu_torch/models/qwen3/huggingface.py",
        "d9d_tpu_torch/dataset/padding.py",
        "d9d_tpu_torch/dataset/sharded.py",
        "d9d_tpu_torch/loop/components/data_loader.py",
        "d9d_tpu_torch/loop/components/prefetch.py",
        "d9d_tpu_torch/loop/components/checkpointer.py",
        "d9d_tpu_torch/resilience/manifest.py",
        "d9d_tpu_torch/example/qwen3_moe/pretrain.py",
    ):
        assert needed in names
    assert {p.name for p in kernel_lib.sources()} == {
        "flash_fwd.cu", "flash_decode.cu", "flash_bwd.cu", "moe_ffn.cu",
        "stochastic.cu"}


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_import_and_no_module_level_triton(path):
    tree = ast.parse(path.read_text())
    for pkg, module_level in _imports(tree):
        assert pkg not in FORBIDDEN, f"{path.name} imports {pkg}"
        if pkg in LAZY_ONLY:
            assert not module_level, (
                f"{path.name} imports {pkg} at module level")


def test_no_library_attention_or_compile_on_the_ports_path():
    """The yardstick calls live only in chip_smoke.py."""
    for path in (ROOT / "d9d_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = getattr(node, "attr", None) or getattr(node, "id", None)
            assert name != "scaled_dot_product_attention", path
            assert name != "_grouped_mm", path
            if isinstance(node, ast.Attribute) and node.attr == "compile":
                assert getattr(node.value, "id", "") != "torch", path


def test_no_environment_switch_between_kernel_and_plain_version():
    for path in (ROOT / "d9d_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "D9D_TPU_DECODE_ATTN" not in text, path
        assert "D9D_TPU_BACKEND_SDPA" not in text, path
        assert "D9D_TPU_FLASH_BWD" not in text, path
        assert "D9D_TPU_MOE" not in text, path
        assert "os.environ" not in text and "getenv" not in text, path
        assert "is_available()" not in text or path.name == "device.py", path


def _qkv(device, dtype=torch.float32, d=64):
    q = torch.zeros(1, 4, 4, d, device=device, dtype=dtype)
    kv = torch.zeros(1, 4, 2, d, device=device, dtype=dtype)
    return q, kv, kv.clone()


def test_flash_wrapper_raises_for_a_non_cpu_non_cuda_tensor():
    q, k, v = _qkv("meta")
    before = (tflash.flash_attention.plain_calls,
              tflash.flash_attention.launches)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tflash.flash_attention(q, k, v)
    after = (tflash.flash_attention.plain_calls,
             tflash.flash_attention.launches)
    assert after == before  # neither the plain version nor a launch ran


def test_decode_wrapper_raises_for_a_non_cpu_non_cuda_tensor():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    cache = torch.zeros(1, 2, 8, 64, device="meta")
    before = (tdec.flash_decode.plain_calls, tdec.flash_decode.launches)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tdec.flash_decode_attention(q, cache, cache, start=torch.tensor(0))
    assert (tdec.flash_decode.plain_calls,
            tdec.flash_decode.launches) == before


@pytest.mark.parametrize("case", ["mask", "cross_length"])
def test_flash_sdpa_raises_off_the_cpu_where_it_has_no_kernel(case):
    """An explicit mask or unequal q/kv lengths goes to eager_sdpa only for
    CPU tensors; any other device raises and the eager branch is not run."""
    sdpa = tflash.make_flash_sdpa()
    q, k, v = _qkv("meta")
    kw = {}
    if case == "mask":
        kw["mask"] = torch.ones(1, 1, 4, 4, dtype=torch.bool, device="meta")
    else:
        q = q[:, :2]
    with pytest.raises(NotImplementedError, match="has no kernel"):
        sdpa(q, k, v, **kw)
    assert sdpa.eager_calls == 0
    # the same call on the CPU takes the eager branch and counts it
    cq, ck, cv = _qkv("cpu")
    ckw = {k_: torch.ones(1, 1, 4, 4, dtype=torch.bool) for k_ in kw}
    sdpa(cq if case == "mask" else cq[:, :2], ck, cv, **ckw)
    assert sdpa.eager_calls == 1


def _flash_check(q, k, v):
    return lambda: tflash._check_kernel_inputs(
        "flash_attention", {"q": q, "k": k, "v": v}, q.shape[-1])


def _ffn_args(dtype=torch.bfloat16, h=128, inter=64, e=4, m_pad=64):
    rows = torch.zeros(m_pad, h, dtype=dtype)
    return dict(rows=rows, gate_w=torch.zeros(e, h, inter, dtype=dtype),
                up_w=torch.zeros(e, h, inter, dtype=dtype),
                down_w=torch.zeros(e, inter, h, dtype=dtype),
                probs=torch.zeros(m_pad), gid=torch.zeros(1, dtype=torch.int32),
                pair_src=torch.zeros(m_pad, dtype=torch.int32))


def _ffn_check(**change):
    args = _ffn_args(**{k: change.pop(k) for k in ("dtype", "h", "inter")
                        if k in change})
    for key, fn in change.items():
        args[key] = fn(args[key])
    return lambda: tmf.check_ffn_inputs("moe_ffn_gather", **args)


@pytest.mark.parametrize(
    "make,exc,match",
    [
        (lambda: _flash_check(*_qkv("cpu", torch.float16)), TypeError,
         "not supported"),
        (lambda: _flash_check(*_qkv("cpu", torch.float64)), TypeError,
         "not supported"),
        (lambda: _flash_check(*_qkv("cpu", d=48)), ValueError, "head_dim 48"),
        (lambda: _flash_check(*(x.requires_grad_() for x in _qkv("cpu"))),
         RuntimeError, "requires grad .* detached"),
        (lambda: _flash_check(*(x[..., ::2] for x in _qkv("cpu", d=128))),
         ValueError, "contiguous head_dim"),
        (lambda: _flash_check(_qkv("cpu")[0], _qkv("cpu")[1].bfloat16(),
                              _qkv("cpu")[2]),
         TypeError, "has dtype"),
        (lambda: _ffn_check(dtype=torch.float16), TypeError, "not supported"),
        (lambda: _ffn_check(h=96), ValueError, "multiples of 64"),
        (lambda: _ffn_check(inter=80), ValueError, "multiples of 64"),
        (lambda: _ffn_check(down_w=lambda w: w.float()), TypeError,
         "down_w has dtype"),
        (lambda: _ffn_check(gate_w=lambda w: w.transpose(1, 2).contiguous()),
         ValueError, "bad shapes"),
        (lambda: _ffn_check(probs=lambda p: p.bfloat16()), TypeError,
         "probs has dtype"),
        (lambda: _ffn_check(pair_src=lambda p: p.long()), TypeError,
         "pair_src has dtype"),
        (lambda: _ffn_check(up_w=lambda w: w.transpose(1, 2).contiguous()
                            .transpose(1, 2)),
         ValueError, "up_w must be contiguous"),
        (lambda: _ffn_check(rows=lambda r: r.requires_grad_()), RuntimeError,
         "requires grad .* FusedMoEFFN"),
    ],
    ids=["fp16", "fp64", "head_dim", "requires_grad", "strided", "mixed",
         "moe_fp16", "moe_hidden_width", "moe_inter_width", "moe_mixed",
         "moe_weight_layout", "moe_probs_dtype", "moe_index_dtype",
         "moe_strided", "moe_requires_grad"],
)
def test_kernel_input_checks_raise(make, exc, match):
    check = make()
    with pytest.raises(exc, match=match):
        check()


def test_cpu_tensors_take_the_plain_version_and_count_it():
    q, k, v = _qkv("cpu")
    before = tflash.flash_attention.plain_calls
    launches = tflash.flash_attention.launches
    tflash.flash_attention(q, k, v)
    assert tflash.flash_attention.plain_calls == before + 1
    assert tflash.flash_attention.launches == launches
    before = tdec.flash_decode.plain_calls
    tdec.flash_decode(q[:, :1], torch.zeros(1, 2, 8, 64),
                      torch.zeros(1, 2, 8, 64), start=torch.tensor(0))
    assert tdec.flash_decode.plain_calls == before + 1


def test_kernel_library_is_keyed_by_its_sources_and_never_built_on_import():
    d = kernel_lib.build_dir()
    assert d.name == kernel_lib._source_hash() and len(d.name) == 16
    assert "build" in d.parts
    assert kernel_lib._lib is None  # nothing in the CPU tests builds it
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        kernel_lib.check_launch(700, "flash_attention")
    kernel_lib.check_launch(0, "flash_attention")
    for name, argtypes in kernel_lib._SIGNATURES.items():
        assert (name.startswith("d9d_flash_") and len(argtypes) > 20
                or name == "d9d_moe_ffn" and len(argtypes) == 17)


def test_flash_bwd_wrapper_raises_for_a_non_cpu_non_cuda_tensor():
    q, k, v = _qkv("meta")
    lse = torch.zeros(1, 4, 4, device="meta")
    names = ("dq_launches", "dkv_launches", "fused_launches", "plain_calls")
    before = [getattr(tflash.flash_attention_bwd, n) for n in names]
    for fused in (False, True):
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            tflash.flash_attention_bwd(q, k, v, q, lse, lse, fused=fused)
    assert [getattr(tflash.flash_attention_bwd, n) for n in names] == before


def test_moe_ffn_raises_for_a_non_cpu_non_cuda_tensor():
    """Meta-device inputs to fused_moe_ffn_apply and to each MoE kernel
    wrapper raise, and neither a plain version nor a launch runs."""
    e, k, n, h = 4, 2, 8, 64
    ids = torch.randint(0, e, (n, k), device="meta")
    sort = tmoe.sort_tokens_by_expert(ids, e)
    x = torch.zeros(n, h, device="meta")
    probs = torch.zeros(n, k, device="meta")
    w = [torch.zeros(e, h, h, device="meta") for _ in range(3)]
    fns = (tmf.moe_ffn_aligned, tmf.moe_ffn_gather, tmf.moe_ffn_gather_combine)
    before = [(f.plain_calls, f.launches) for f in fns]
    for gather, combine in tmf.MOE_FFN_VARIANTS.values():
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            tmf.fused_moe_ffn_apply(x, probs, sort, *w, torch.float32,
                                    num_experts=e, gather=gather,
                                    combine=combine)
    gid = torch.zeros(2, dtype=torch.int32, device="meta")
    pair_src = torch.zeros(32, dtype=torch.int32, device="meta")
    pf = probs.reshape(-1)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tmf.moe_ffn_aligned(torch.zeros(32, h, device="meta"),
                            torch.zeros(32, device="meta"), gid, pair_src, *w)
    for fn in fns[1:]:
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            fn(x, pf, gid, pair_src, *w, top_k=k)
    assert [(f.plain_calls, f.launches) for f in fns] == before
