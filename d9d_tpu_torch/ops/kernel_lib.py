"""Build and load the port's hand-written CUDA kernels.

The sources under ``d9d_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface and loaded with
``ctypes``. Each ``*.cu`` file is compiled by its own ``nvcc -c`` process,
all started together, then linked; sources that include no PyTorch header
build in seconds. The build happens at first use (never at import), lands
in ``build/d9d_tpu_torch_kernels/<hash>/`` under the repository root and is
keyed by a hash of the sources, so an edit rebuilds.

A failed build or a missing ``nvcc`` raises: nothing here falls back to a
plain PyTorch path.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
# seconds the last build took (0.0 when a cached library was loaded);
# read by the smoke script's build phase
last_build_seconds: float = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the exported launchers (see the .cu files)
_SIGNATURES = {
    "d9d_flash_fwd": [
        _P, _P, _P, _P, _P,          # q, k, v, o, lse
        _P, _P,                      # q_seg, kv_seg (nullable)
        _I, _I, _I, _I, _I, _I,      # B, T, Hq, Hkv, D, dtype
        _L, _L, _L,                  # q strides (batch, token, head)
        _L, _L, _L,                  # k strides (batch, token, head)
        _L, _L, _L,                  # v strides (batch, token, head)
        _L, _L, _L,                  # o strides (batch, token, head)
        _F, _I, _I,                  # scale, causal, window (-1 = none)
        _I,                          # shift = q_offset - k_offset
        _P,                          # stream
    ],
    "d9d_flash_bwd": [
        _P, _P, _P, _P,              # q, k, v, do
        _P, _P, _P, _P,              # lse, delta, q_seg, kv_seg (nullable)
        _P, _P, _P,                  # dq (fp32 accumulator when fused), dk, dv
        _P,                          # dq turnstile (fused; nullable)
        _I, _I, _I, _I, _I, _I, _I,  # B, T, Hq, Hkv, D, dtype, kernel
        _L, _L, _L,                  # q strides (batch, token, head)
        _L, _L, _L,                  # k strides
        _L, _L, _L,                  # v strides
        _L, _L, _L,                  # do strides
        _F, _I, _I,                  # scale, causal, window (-1 = none)
        _I,                          # shift = q_offset - k_offset
        _P,                          # stream
    ],
    "d9d_flash_decode": [
        _P, _P, _P, _P, _P,          # q, k_cache, v_cache, o, lse
        _P, _P,                      # offsets [B], kv_valid [B,S] (nullable)
        _P, _P,                      # o_part, lse_part scratch (nullable)
        _I, _I, _I, _I, _I, _I, _I,  # B, T, Hq, Hkv, S, D, dtype
        _L, _L, _L,                  # q strides (batch, token, head)
        _L, _L, _L,                  # k strides (batch, head, slot)
        _L, _L, _L,                  # v strides (batch, head, slot)
        _L, _L, _L,                  # o strides (batch, token, head)
        _F, _I,                      # scale, window (-1 = none)
        _I, _I,                      # n_splits (cluster core: blocks per
                                     # cluster), split_len
        _L, _I, _L,                  # offsets stride (0: shared), kv_valid
                                     # bytes (1 or 4), kv_valid row stride
        _P,                          # stream
    ],
    "d9d_flash_paged_decode": [
        _P, _P, _P,                  # q, k_pool, v_pool
        _P, _P,                      # k_scale, v_scale (int8 pools; nullable)
        _P, _P,                      # o, lse
        _P, _P,                      # offsets [B], page_table [B, n_pages]
        _P, _P,                      # o_part, lse_part scratch (nullable)
        _I, _I, _I, _I, _I, _I, _I,  # B, T, Hq, Hkv, page_size, n_pages, D
        _I, _I,                      # dtype, kv_int8
        _L, _L, _L,                  # q strides (batch, token, head)
        _L, _L, _L,                  # k pool strides (page, head, slot)
        _L, _L, _L,                  # v pool strides (page, head, slot)
        _L, _L, _L,                  # o strides (batch, token, head)
        _F, _I,                      # scale, window (-1 = none)
        _I, _I,                      # n_splits (cluster core: blocks per
                                     # cluster), split_len
        _L,                          # offsets stride (0: shared)
        _P,                          # stream
    ],
    "d9d_moe_ffn": [
        _P, _P, _P, _P,              # a (rows or x), probs, gid, pair_src
        _P, _P, _P, _P,              # wg, wu, wd, out
        _P,                          # hidden scratch (bf16; null in fp32)
        _I, _I, _I,                  # kernel, n_tiles, num_experts
        _I, _I, _I, _I,              # h, inter, top_k, dtype
        _P,                          # stream
    ],
}

# launchers of elementwise kernels (no attention or expert-FFN strides)
_ELEMENTWISE = {
    "d9d_stochastic_round": [
        _P, _P,                      # x (fp32), out (bf16)
        _L, ctypes.c_ulonglong,      # numel, 64-bit seed
        _L, _L, _L,                  # index offset, cols, row stride
        _P,                          # stream
    ],
}

# host-side queries: no launch, same int status as the launchers
_QUERIES = {
    "d9d_flash_decode_tiling": [
        _I, _I, _I,                  # dtype, query rows per kv head, paged
        ctypes.POINTER(_I),          # out: query rows per block
        ctypes.POINTER(_I),          # out: granularity of split_len (0: the
                                     # cluster core, no split scratch)
    ],
    "d9d_flash_decode_max_clusters": [
        _I, _I, _I, _I,              # paged, kv_int8, head_dim, cluster size
        ctypes.POINTER(_I),          # out: clusters the card holds at once
    ],
    "d9d_moe_ffn_tiling": [
        _I, _I, _I,                  # dtype, h, inter
        ctypes.POINTER(_I),          # out: rows per tile (block_m)
    ],
}


def sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_ARCH_FLAGS + _NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    base = _CSRC.parent.parent / "build" / "d9d_tpu_torch_kernels"
    return base / _source_hash()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for cand in ("/usr/local/cuda/bin/nvcc",):
            if os.path.exists(cand):
                nvcc = cand
                break
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the d9d_tpu_torch CUDA kernels are compiled "
            "from source at first use and need the CUDA toolkit"
        )
    return nvcc


def _build(out: pathlib.Path) -> None:
    global last_build_seconds
    nvcc = _find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out.parent / (src.stem + ".o")
        cmd = [nvcc, *_ARCH_FLAGS, *_NVCC_FLAGS, "-I", str(_CSRC),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    objs = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            for _s, _o, other in procs:
                if other.poll() is None:
                    other.kill()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        objs.append(str(obj))
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    link = subprocess.run(
        [nvcc, *_ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)  # atomic: concurrent processes never see a torn file
    last_build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = build_dir() / "libd9d_tpu_torch_kernels.so"
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in {**_SIGNATURES, **_ELEMENTWISE,
                               **_QUERIES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check_launch(code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")
