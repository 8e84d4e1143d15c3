"""Stochastic rounding fp32 -> bf16: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``d9d_tpu/ops/stochastic.py``: the rounding rule
``_sr_bits`` (add 16 random low bits, truncate), the jnp function
``stochastic_round_to_bf16`` and the Pallas kernel ``_sr_kernel`` behind
``stochastic_round_to_bf16_pallas``. The kernel is ``d9d_stochastic_round``
of ``d9d_tpu_torch/csrc/stochastic.cu``.

The random bits are a counter-based function of ``(seed, element index)``
(:func:`random_bits`), never of the launch configuration, so the plain
version and the kernel compute the same bits and are held to each other bit
for bit. The index is the element's flat index in the WHOLE tensor: a
tensor that is one rank's piece of a sharded one (``parallel/shards.py``)
passes where it lies there (:func:`shard_index`), so a sharded optimizer
step rounds every element with the bits the unsharded step gives it. A
piece cut on dim 0 is one run of the whole tensor's flat index
(``index_offset``); a piece cut on a later dim is one run per row, of
``cols`` elements each, the rows ``row_stride`` apart; a block (dim 0 cut
by tensor parallelism, dim 1 by FSDP) is the same runs from its first
row on.

The bits are not the TPU's: a ``jax.random`` key stream and the
TPU's on-chip PRNG cannot be reproduced here, so against the JAX package the
parity is the rule's (``_sr_bits`` on the same bits) and the distribution's.

Non-finite inputs pass through: ``±inf`` stays ``±inf`` and NaN becomes the
quiet NaN ``0x7FC0`` (the JAX package casts them; PyTorch's casts give other
NaN payloads on the CPU and the card, so the bits are fixed here). A finite
value just under the largest finite bf16 may round up to ``inf``, as the
JAX rule does.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

import math

import torch

_MANTISSA_MASK = 0xFFFF  # bits dropped when truncating fp32 -> bf16
_BF16_MASK = 0xFFFF0000
_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF
_BF16_QNAN = 0x7FC0

# murmur3's fmix32 constants
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35


def _sr_bits(x_bits: torch.Tensor, rand_bits: torch.Tensor) -> torch.Tensor:
    """Core rounding rule on uint32 values held in int64 tensors (torch's
    CPU ``uint32`` arithmetic is incomplete): add the 16 low random bits,
    keep the top 16 of the 32."""
    return (x_bits + (rand_bits & _MANTISSA_MASK)) & _BF16_MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in ``[0, 2^32)``, from 16-bit halves of
    ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_C2)
    return h ^ (h >> 16)


def shard_index(shape, bounds) -> tuple[int, int, int]:
    """``(index_offset, cols, row_stride)`` of a piece of a tensor of the
    whole ``shape``, cut to ``bounds`` (``[(dim, start, length)]`` as
    ``parallel/shards.py`` ``shard_bounds`` gives them: one dim, or dim 0
    and one later dim, a block): viewed as ``[prod(shape[:dim]), ...]``
    rows, the piece holds ``cols`` elements of each row from
    ``index_offset`` on, rows ``row_stride`` apart. A block cut to rows
    ``[r0, r0 + nr)`` of dim 0 starts ``r0 * prod(shape[1:])`` further on.
    ``(0, n, n)`` for a whole tensor of ``n`` elements."""
    if not bounds:
        n = math.prod(shape)
        return 0, max(n, 1), max(n, 1)
    if len(bounds) > 2 or (len(bounds) == 2 and bounds[0][0] != 0):
        raise ValueError(f"a piece cut on dims other than dim 0 and one "
                         f"later dim: {bounds}")
    *outer, (dim, start, length) = bounds
    inner = math.prod(shape[dim + 1:])
    cols = max(length * inner, 1)
    row_stride = cols if dim == 0 else max(shape[dim] * inner, cols)
    offset = start * inner
    for _, row0, _ in outer:
        offset += row0 * math.prod(shape[1:])
    return offset, cols, row_stride


def _global_index(n, index_offset, cols, row_stride, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    if cols == row_stride:
        return i + index_offset
    return index_offset + (i // cols) * row_stride + i % cols


def random_bits(seed: int, n: int, device="cpu", *, index_offset: int = 0,
                cols: int | None = None,
                row_stride: int | None = None) -> torch.Tensor:
    """32 random bits per element ``i < n`` → int64 ``[n]`` in ``[0,
    2^32)``: two rounds of fmix32 over the element's index in the whole
    tensor (``index_offset + (i // cols) * row_stride + i % cols``;
    ``index_offset + i`` without ``cols``), keyed by the two 32-bit halves
    of the 64-bit ``seed`` (the kernel's ``random_bits``)."""
    seed &= _U64
    k0, k1 = seed & _U32, seed >> 32
    cols = cols or max(n, 1)
    idx = _global_index(n, index_offset, cols, row_stride or cols, device)
    h = _fmix32((idx & _U32) ^ k0)
    return _fmix32(h ^ (idx >> 32) ^ k1)


def fold_seed(seed: int, *values: int) -> int:
    """A 64-bit seed from ``seed`` and the ``values`` folded in one after
    the other through splitmix64's finalizer (host arithmetic, no device
    work). The optimizer folds (step count, leaf index, role) in, as the
    JAX optimizer folds them into its key."""
    def mix(z: int) -> int:
        z = (z + 0x9E3779B97F4A7C15) & _U64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        return z ^ (z >> 31)

    z = mix(seed & _U64)
    for v in values:
        z = mix(z ^ (v & _U64))
    return z


def _uint16_to_bf16(bits: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^16)`` → the bf16 tensor of those bits."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.bfloat16)


def stochastic_round_to_bf16_with_bits(
    x: torch.Tensor, rand_bits: torch.Tensor
) -> torch.Tensor:
    """Round ``x`` (any float dtype) to bf16 with the given random bits
    (int64, ``x``'s shape, values in ``[0, 2^32)``)."""
    xf = x.to(torch.float32).contiguous()
    bits = xf.view(torch.int32).to(torch.int64) & _U32
    finite = (bits & 0x7F800000) != 0x7F800000
    nan = ~finite & ((bits & 0x007FFFFF) != 0)
    out = torch.where(finite, _sr_bits(bits, rand_bits), bits) >> 16
    out = torch.where(nan, torch.full_like(out, _BF16_QNAN), out)
    return _uint16_to_bf16(out)


def stochastic_round_to_bf16_plain(x: torch.Tensor, seed: int, *,
                                   index_offset: int = 0,
                                   cols: int | None = None,
                                   row_stride: int | None = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the bits of
    :func:`random_bits` ``(seed, index in the whole tensor)`` through the
    rule."""
    rand = random_bits(seed, x.numel(), x.device, index_offset=index_offset,
                       cols=cols, row_stride=row_stride).reshape(x.shape)
    return stochastic_round_to_bf16_with_bits(x, rand)


def stochastic_round_to_bf16(
    x: torch.Tensor, seed: int, *, out: torch.Tensor | None = None,
    index_offset: int = 0, cols: int | None = None,
    row_stride: int | None = None,
) -> torch.Tensor:
    """Stochastically round ``x`` (any float dtype) to bf16: E[result] is
    ``x`` for finite values. ``seed`` is a 64-bit int; the same seed gives
    the same bits, so callers fold their step and role in
    (:func:`fold_seed`). ``out``: a contiguous bf16 tensor of ``x``'s shape
    written in place (a parameter, say), returned. ``index_offset``,
    ``cols``, ``row_stride``: where ``x``'s elements lie in the whole
    tensor when ``x`` is a piece of it (:func:`shard_index`; by default
    ``x`` is whole).

    A CPU tensor takes :func:`stochastic_round_to_bf16_plain`; a CUDA
    tensor launches kernel B10. Counters: ``stochastic_round_to_bf16
    .launches`` (``plain_calls`` on the CPU)."""
    if out is not None and (out.dtype != torch.bfloat16
                            or out.shape != x.shape
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(
            f"stochastic_round_to_bf16: out must be a contiguous bf16 tensor "
            f"of shape {tuple(x.shape)} on {x.device}, got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}")
    if not x.is_floating_point():
        raise TypeError(f"stochastic_round_to_bf16: {x.dtype} is not a float")
    n = x.numel()
    cols = cols or max(n, 1)
    row_stride = row_stride or cols
    if index_offset < 0 or row_stride < cols or n % cols != 0:
        raise ValueError(
            f"stochastic_round_to_bf16: index_offset {index_offset}, cols "
            f"{cols}, row_stride {row_stride} do not place {n} elements")
    if x.device.type == "cpu":
        stochastic_round_to_bf16.plain_calls += 1
        y = stochastic_round_to_bf16_plain(
            x, seed, index_offset=index_offset, cols=cols,
            row_stride=row_stride)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"stochastic_round_to_bf16: no kernel for device {x.device}; "
            f"tensors must lie on a CUDA device (kernel) or the CPU (plain "
            f"version)")
    from d9d_tpu_torch.ops import kernel_lib

    xf = x.to(torch.float32).contiguous()
    if out is None:
        out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lib = kernel_lib.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.d9d_stochastic_round(xf.data_ptr(), out.data_ptr(),
                                       xf.numel(), seed & _U64, index_offset,
                                       cols, row_stride, stream)
    kernel_lib.check_launch(err, "stochastic_round_to_bf16")
    stochastic_round_to_bf16.launches += 1
    return out


stochastic_round_to_bf16.launches = 0
stochastic_round_to_bf16.plain_calls = 0


__all__ = [
    "fold_seed",
    "random_bits",
    "shard_index",
    "stochastic_round_to_bf16",
    "stochastic_round_to_bf16_plain",
    "stochastic_round_to_bf16_with_bits",
]
