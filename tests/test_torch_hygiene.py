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

torch.set_num_threads(1)

ROOT = pathlib.Path(d9d_tpu_torch.__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "d9d_tpu"}
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
    ):
        assert needed in names
    assert {p.name for p in kernel_lib.sources()} == {
        "flash_fwd.cu", "flash_decode.cu"}


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
    """The yardstick call lives only in chip_smoke.py."""
    for path in (ROOT / "d9d_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = getattr(node, "attr", None) or getattr(node, "id", None)
            assert name != "scaled_dot_product_attention", path
            if isinstance(node, ast.Attribute) and node.attr == "compile":
                assert getattr(node.value, "id", "") != "torch", path


def test_no_environment_switch_between_kernel_and_plain_version():
    for path in (ROOT / "d9d_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "D9D_TPU_DECODE_ATTN" not in text, path
        assert "D9D_TPU_BACKEND_SDPA" not in text, path
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


@pytest.mark.parametrize(
    "make,exc,match",
    [
        (lambda: _qkv("cpu", torch.float16), TypeError, "not supported"),
        (lambda: _qkv("cpu", torch.float64), TypeError, "not supported"),
        (lambda: _qkv("cpu", d=32), ValueError, "head_dim 32"),
        (lambda: tuple(x.requires_grad_() for x in _qkv("cpu")),
         RuntimeError, "forward-only"),
        (lambda: tuple(x[..., ::2] for x in _qkv("cpu", d=128)),
         ValueError, "contiguous head_dim"),
        (lambda: (_qkv("cpu")[0], _qkv("cpu")[1].bfloat16(), _qkv("cpu")[2]),
         TypeError, "has dtype"),
    ],
    ids=["fp16", "fp64", "head_dim", "requires_grad", "strided", "mixed"],
)
def test_kernel_input_checks_raise(make, exc, match):
    q, k, v = make()
    with pytest.raises(exc, match=match):
        tflash._check_kernel_inputs(
            "flash_attention", {"q": q, "k": k, "v": v}, q.shape[-1])


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
        assert name.startswith("d9d_flash_") and len(argtypes) > 20
