"""The fused expert FFN of a MoE layer over the group-aligned tile layout:
the CUDA kernels' wrappers, their plain PyTorch versions, the reference
chain and the autograd ``Function`` built on them.

Counterpart of ``d9d_tpu/ops/moe_pallas.py``: ``AlignedMeta`` /
``aligned_metadata``, the three Pallas kernels (``_ffn_kernel``,
``_ffn_gather_kernel``, ``_ffn_gather_combine_kernel`` through their
``_fused_*_call``), ``_reference_apply``, the ``custom_vjp``
``fused_moe_ffn`` and ``fused_moe_ffn_apply``. The kernels themselves are
``d9d_tpu_torch/csrc/moe_ffn.cu``; in bfloat16 all three — aligned (B5),
gather (B6), gather + combine (B7) — run on its Hopper core
``csrc/moe_ffn_sm90.cuh``: two device kernels a call (gate-up, then down)
that pass the hidden through a bf16 ``[m_pad, i]`` buffer the wrapper
allocates. Their launch counters count calls.

The layout: expert groups of the expert-sorted (token, k) pairs are padded
to ``block_m`` multiples, so every tile of ``block_m`` rows belongs to ONE
expert; pad rows are zero and weigh 0, so no number depends on
``block_m``. For CUDA tensors ``block_m`` is the kernel's choice (the
wrappers ask the library, ``d9d_moe_ffn_tiling``); the plain versions take
any layout.

The variant is an argument (``gather``, ``combine``), never read from the
environment, and a shape outside a kernel's domain raises: nothing falls
back. Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises. The wrappers refuse inputs that require
grad: gradients go through :class:`FusedMoEFFN`.
"""

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from d9d_tpu_torch.ops.moe import (
    TokenSort,
    grouped_swiglu_apply,
    permute_tokens,
    unpermute_combine,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# h and i must be multiples of this (the kernels' 64-wide column chunks)
KERNEL_WIDTH_MULTIPLE = 64
# rows per tile of the layout on the CPU, where no kernel chooses it
PLAIN_BLOCK_M = 16

# moe_ffn value of MoELayer / Qwen3MoeCausalLM → (gather, combine)
MOE_FFN_VARIANTS = {
    "aligned": (False, False),        # B5: _ffn_kernel
    "gather": (True, False),          # B6: _ffn_gather_kernel
    "gather_combine": (True, True),   # B7: _ffn_gather_combine_kernel
}


class AlignedMeta(NamedTuple):
    """Group-aligned layout descriptors.

    dest_aligned: int64 ``[M]`` aligned row of each (token, k) pair (the
        combine's gather indices).
    pair_src: int32 ``[m_pad]`` pair of each aligned row, -1 for pad rows.
    gid: int32 ``[m_pad / block_m]`` expert of each tile (trailing pad tiles
        clamp to E-1).
    m_pad: static length of the layout, ``(ceil(M / block_m) + E) *
        block_m`` — every group pads by less than ``block_m``, so it always
        fits and needs no readback.
    """

    dest_aligned: torch.Tensor
    pair_src: torch.Tensor
    gid: torch.Tensor
    m_pad: int


def aligned_metadata(sort: TokenSort, num_experts: int,
                     block_m: int) -> AlignedMeta:
    """The aligned layout of a :class:`TokenSort`, from shapes and device
    ops only (no readback)."""
    m = sort.sort_idx.shape[0]
    dev = sort.sort_idx.device
    m_pad = (-(-m // block_m) + num_experts) * block_m
    gs = sort.group_sizes.to(torch.int64)
    padded = (gs + block_m - 1) // block_m * block_m
    ends = torch.cumsum(gs, 0)
    padded_ends = torch.cumsum(padded, 0)
    aligned_starts = padded_ends - padded
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    expert_of_row = torch.searchsorted(ends, rows, right=True)
    rank = rows - (ends - gs)[expert_of_row]
    aligned_pos = aligned_starts[expert_of_row] + rank
    dest_aligned = aligned_pos[sort.dest]
    pair_src = torch.full((m_pad,), -1, dtype=torch.int32, device=dev)
    pair_src.scatter_(0, dest_aligned,
                      torch.arange(m, dtype=torch.int32, device=dev))
    tile_starts = torch.arange(0, m_pad, block_m, dtype=torch.int64, device=dev)
    gid = torch.clamp(
        torch.searchsorted(padded_ends, tile_starts, right=True),
        max=num_experts - 1).to(torch.int32)
    return AlignedMeta(dest_aligned=dest_aligned, pair_src=pair_src, gid=gid,
                       m_pad=m_pad)


# ---------------------------------------------------------------------------
# plain versions


def _layout_block_m(gid: torch.Tensor, pair_src: torch.Tensor) -> int:
    n_tiles = gid.shape[0]
    if n_tiles == 0 or pair_src.shape[0] % n_tiles:
        raise ValueError(
            f"layout of {pair_src.shape[0]} rows does not split into "
            f"{n_tiles} tiles")
    return pair_src.shape[0] // n_tiles


def _tile_ffn_plain(a, probs, gid, gate_w, up_w, down_w,
                    block_m: int) -> torch.Tensor:
    """``y * probs`` in fp32, ``[m_pad, h]``, over the aligned rows ``a``:
    per tile, ``(silu(a Wg) * (a Wu)).to(a.dtype) Wd`` with fp32 products
    of the given values. Consecutive tiles of one expert go through one
    product (rows are independent); the tiles' experts are read back once."""
    m_pad, h = a.shape
    y = torch.zeros((m_pad, h), dtype=torch.float32, device=a.device)
    experts = gid.tolist()
    t = 0
    while t < len(experts):
        e, end = experts[t], t
        while end < len(experts) and experts[end] == e:
            end += 1
        rows = slice(t * block_m, end * block_m)
        at = a[rows].float()
        g = at @ gate_w[e].float()
        u = at @ up_w[e].float()
        hidden = (F.silu(g) * u).to(a.dtype).float()
        y[rows] = (hidden @ down_w[e].float()) * probs[rows, None].float()
        t = end
    return y


def _gathered_rows(x, probs_flat, pair_src, top_k):
    """The aligned rows and probs a gather tile builds: row of token
    ``pair_src // top_k`` and prob ``probs_flat[pair_src]``; zeros for pad
    rows."""
    valid = pair_src >= 0
    src = torch.clamp(pair_src, min=0).to(torch.int64)
    a = torch.where(valid[:, None], x.index_select(0, src // top_k),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    p = torch.where(valid, probs_flat.float().index_select(0, src),
                    torch.zeros((), device=x.device))
    return a, p


def moe_ffn_aligned_plain(a, probs, gid, pair_src, gate_w, up_w, down_w):
    """Plain version of the aligned kernel (``_ffn_kernel``): aligned rows
    ``a [m_pad, h]``, their probs ``[m_pad]`` fp32 (pad rows zero) → ``y
    [m_pad, h]`` in ``a``'s dtype."""
    bm = _layout_block_m(gid, pair_src)
    return _tile_ffn_plain(a, probs, gid, gate_w, up_w, down_w, bm).to(a.dtype)


def moe_ffn_gather_plain(x, probs_flat, gid, pair_src, gate_w, up_w, down_w,
                         *, top_k: int):
    """Plain version of the gather kernel (``_ffn_gather_kernel``): tokens
    ``x [N, h]``, flat probs ``[N*K]`` fp32 → aligned ``y [m_pad, h]``."""
    bm = _layout_block_m(gid, pair_src)
    a, p = _gathered_rows(x, probs_flat, pair_src, top_k)
    return _tile_ffn_plain(a, p, gid, gate_w, up_w, down_w, bm).to(x.dtype)


def moe_ffn_gather_combine_plain(x, probs_flat, gid, pair_src, gate_w, up_w,
                                 down_w, *, top_k: int):
    """Plain version of the gather + combine kernel
    (``_ffn_gather_combine_kernel``): → token-major ``[N, h]`` in ``x``'s
    dtype, each token the fp32 sum of its K prob-weighted expert rows,
    rounded once."""
    bm = _layout_block_m(gid, pair_src)
    a, p = _gathered_rows(x, probs_flat, pair_src, top_k)
    y = _tile_ffn_plain(a, p, gid, gate_w, up_w, down_w, bm)
    valid = pair_src >= 0
    tok = pair_src[valid].to(torch.int64) // top_k
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return out.index_add_(0, tok, y[valid]).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers


def check_ffn_inputs(name: str, rows, gate_w, up_w, down_w, probs, gid,
                     pair_src) -> int:
    """Device, dtype, layout and width checks shared by the CUDA wrappers
    (the shared-memory fit is the library's: :func:`kernel_block_m`);
    returns the dtype code the launcher takes."""
    if rows.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"{name}: dtype {rows.dtype} is not supported by the kernel "
            f"(float32 and bfloat16 are)")
    e, h, inter = gate_w.shape
    if rows.shape[-1] != h or up_w.shape != gate_w.shape \
            or down_w.shape != (e, inter, h):
        raise ValueError(
            f"{name}: bad shapes rows {tuple(rows.shape)} gate "
            f"{tuple(gate_w.shape)} up {tuple(up_w.shape)} down "
            f"{tuple(down_w.shape)}")
    if h % KERNEL_WIDTH_MULTIPLE or inter % KERNEL_WIDTH_MULTIPLE:
        raise ValueError(
            f"{name}: hidden {h} and intermediate {inter} must be multiples "
            f"of {KERNEL_WIDTH_MULTIPLE} (the kernel's domain)")
    for label, t, dtype in (("rows", rows, rows.dtype),
                            ("gate_w", gate_w, rows.dtype),
                            ("up_w", up_w, rows.dtype),
                            ("down_w", down_w, rows.dtype),
                            ("probs", probs, torch.float32),
                            ("gid", gid, torch.int32),
                            ("pair_src", pair_src, torch.int32)):
        if t.device != rows.device:
            raise ValueError(f"{name}: {label} lies on {t.device}, expected "
                             f"{rows.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: {label} requires grad — the kernels take detached "
                f"tensors; differentiate through FusedMoEFFN "
                f"(fused_moe_ffn_apply)")
    return _DTYPE_CODE[rows.dtype]


_block_m_cache: dict = {}


def kernel_block_m(dtype: torch.dtype, h: int, inter: int) -> int:
    """Rows per tile of the CUDA kernels for this dtype and widths, as the
    library reports them; raises outside the kernels' domain."""
    key = (dtype, h, inter)
    if key not in _block_m_cache:
        from d9d_tpu_torch.ops import kernel_lib

        if dtype not in _DTYPE_CODE:
            raise TypeError(f"moe_ffn: dtype {dtype} has no kernel")
        bm = ctypes.c_int()
        if kernel_lib.load().d9d_moe_ffn_tiling(
                _DTYPE_CODE[dtype], h, inter, ctypes.byref(bm)) != 0:
            raise ValueError(
                f"moe_ffn: hidden {h}, intermediate {inter} in {dtype} are "
                f"outside the kernels' domain (multiples of "
                f"{KERNEL_WIDTH_MULTIPLE}, hidden tile within shared memory)")
        _block_m_cache[key] = bm.value
    return _block_m_cache[key]


def _no_kernel(name, device):
    return RuntimeError(
        f"{name}: no kernel for device {device}; tensors must lie on a CUDA "
        f"device (kernel) or the CPU (plain version)")


def _launch(name, kernel, rows, probs, gid, pair_src, gate_w, up_w, down_w,
            out, top_k):
    """One call of ``d9d_moe_ffn`` on checked tensors; raises on a launch
    error. In bf16 every kernel runs the sm_90 core's two launches through
    a hidden buffer allocated here and dropped after the call. Counts
    nothing: each wrapper counts its own calls."""
    from d9d_tpu_torch.ops import kernel_lib

    code = check_ffn_inputs(name, rows, gate_w, up_w, down_w, probs, gid,
                            pair_src)
    e, h, inter = gate_w.shape
    bm = _layout_block_m(gid, pair_src)
    if bm != kernel_block_m(rows.dtype, h, inter):
        raise ValueError(
            f"{name}: layout of {bm}-row tiles; the kernel takes "
            f"{kernel_block_m(rows.dtype, h, inter)} in {rows.dtype}")
    hidden = None
    if rows.dtype == torch.bfloat16:
        hidden = torch.empty((pair_src.shape[0], inter), dtype=rows.dtype,
                             device=rows.device)
    lib = kernel_lib.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.d9d_moe_ffn(
            rows.data_ptr(), probs.data_ptr(), gid.data_ptr(),
            pair_src.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(),
            down_w.data_ptr(), out.data_ptr(),
            None if hidden is None else hidden.data_ptr(), kernel,
            gid.shape[0], e, h, inter, top_k, code, stream)
    kernel_lib.check_launch(err, name)


def moe_ffn_aligned(a, probs, gid, pair_src, gate_w, up_w, down_w):
    """Aligned kernel (B5) → ``y [m_pad, h]`` (see
    :func:`moe_ffn_aligned_plain`). CUDA tensors run kernel 0 of
    ``d9d_moe_ffn`` (bf16: the sm_90 core's gate-up and down launches);
    ``pair_src`` tells it which tiles are all padding. Counter:
    ``moe_ffn_aligned.launches``, one per call (``plain_calls`` on the
    CPU)."""
    if a.device.type == "cpu":
        moe_ffn_aligned.plain_calls += 1
        return moe_ffn_aligned_plain(a, probs, gid, pair_src, gate_w, up_w,
                                     down_w)
    if a.device.type != "cuda":
        raise _no_kernel("moe_ffn_aligned", a.device)
    if a.shape[0] != pair_src.shape[0] or probs.shape != (a.shape[0],):
        raise ValueError(
            f"moe_ffn_aligned: rows {tuple(a.shape)}, probs "
            f"{tuple(probs.shape)} and pair_src {tuple(pair_src.shape)} "
            f"disagree")
    out = torch.empty_like(a)
    _launch("moe_ffn_aligned", 0, a, probs, gid, pair_src, gate_w, up_w,
            down_w, out, 1)
    moe_ffn_aligned.launches += 1
    return out


moe_ffn_aligned.launches = 0
moe_ffn_aligned.plain_calls = 0


def _check_gather_shapes(name, x, probs_flat, top_k):
    if top_k <= 0 or probs_flat.shape != (x.shape[0] * top_k,):
        raise ValueError(
            f"{name}: probs {tuple(probs_flat.shape)} are not the N*K = "
            f"{x.shape[0]}*{top_k} flat pair probs")


def moe_ffn_gather(x, probs_flat, gid, pair_src, gate_w, up_w, down_w, *,
                   top_k: int):
    """Gather kernel (B6) → aligned ``y [m_pad, h]`` (see
    :func:`moe_ffn_gather_plain`): kernel 1 of ``d9d_moe_ffn`` (bf16: the
    sm_90 core's gathering gate-up launch, then its down launch, which
    stores ``y`` as B5's does and writes the zeros of all-padding tiles)
    reads each row straight from ``x`` by ``pair_src`` and its prob from
    ``probs_flat``. Counter: ``moe_ffn_gather.launches``, one per call."""
    if x.device.type == "cpu":
        moe_ffn_gather.plain_calls += 1
        return moe_ffn_gather_plain(x, probs_flat, gid, pair_src, gate_w,
                                    up_w, down_w, top_k=top_k)
    if x.device.type != "cuda":
        raise _no_kernel("moe_ffn_gather", x.device)
    _check_gather_shapes("moe_ffn_gather", x, probs_flat, top_k)
    out = torch.empty((pair_src.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    _launch("moe_ffn_gather", 1, x, probs_flat, gid, pair_src, gate_w, up_w,
            down_w, out, top_k)
    moe_ffn_gather.launches += 1
    return out


moe_ffn_gather.launches = 0
moe_ffn_gather.plain_calls = 0


def moe_ffn_gather_combine(x, probs_flat, gid, pair_src, gate_w, up_w,
                           down_w, *, top_k: int):
    """Gather + combine kernel (B7) → token-major ``[N, h]`` in ``x``'s
    dtype (see :func:`moe_ffn_gather_combine_plain`). Kernel 2 of
    ``d9d_moe_ffn`` (bf16: the sm_90 core's gate-up and down launches) adds
    each row's fp32 prob-weighted output into a zeroed fp32 ``[N, h]``
    buffer by atomic adds; one cast follows. The order of
    a token's K-sum is the order the atomics land, so the result may differ
    between runs in its last fp32 bits before the cast; the TPU kernel sums
    in expert order in the output dtype, the port rounds once. Counter:
    ``moe_ffn_gather_combine.launches``, one per call."""
    if x.device.type == "cpu":
        moe_ffn_gather_combine.plain_calls += 1
        return moe_ffn_gather_combine_plain(x, probs_flat, gid, pair_src,
                                            gate_w, up_w, down_w, top_k=top_k)
    if x.device.type != "cuda":
        raise _no_kernel("moe_ffn_gather_combine", x.device)
    _check_gather_shapes("moe_ffn_gather_combine", x, probs_flat, top_k)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    _launch("moe_ffn_gather_combine", 2, x, probs_flat, gid, pair_src, gate_w,
            up_w, down_w, out, top_k)
    moe_ffn_gather_combine.launches += 1
    return out.to(x.dtype)


moe_ffn_gather_combine.launches = 0
moe_ffn_gather_combine.plain_calls = 0


# ---------------------------------------------------------------------------
# reference chain, autograd and the entry point


def reference_apply(x, probs, sort: TokenSort, gate_w, up_w, down_w,
                    dtype: torch.dtype) -> torch.Tensor:
    """The expert FFN as the JAX package's XLA chain computes it (permute →
    grouped gate/up products → silu·mul → grouped down product → × probs →
    combine) → ``[N, h]`` in ``x``'s dtype. The grouped products slice rows
    by the group sizes: one readback per call
    (``group_sizes_on_host.readbacks``). The backward of
    :class:`FusedMoEFFN` differentiates this chain, as the JAX
    ``custom_vjp`` does, and the tests hold the kernels' path against it."""
    permuted_x, permuted_probs = permute_tokens(x, probs, sort)
    y = grouped_swiglu_apply(permuted_x, permuted_probs, sort.group_sizes,
                             gate_w, up_w, down_w, dtype)
    return unpermute_combine(y, sort, x.shape[0]).to(x.dtype)


def _fused_forward(x, probs, gate_w, up_w, down_w, sort, num_experts,
                   gather, combine, block_m):
    n, h = x.shape
    k = sort.dest.shape[0] // n
    meta = aligned_metadata(sort, num_experts, block_m)
    xx = x.to(gate_w.dtype).contiguous()
    probs_flat = probs.reshape(-1).to(torch.float32).contiguous()
    w = (gate_w.contiguous(), up_w.contiguous(), down_w.contiguous())
    if gather and combine:
        out = moe_ffn_gather_combine(xx, probs_flat, meta.gid, meta.pair_src,
                                     *w, top_k=k)
        return out.to(x.dtype)
    if gather:
        y = moe_ffn_gather(xx, probs_flat, meta.gid, meta.pair_src, *w,
                           top_k=k)
    else:
        # ONE gather fills the aligned activation buffer (pad rows zero)
        a, p = _gathered_rows(xx, probs_flat, meta.pair_src, k)
        y = moe_ffn_aligned(a.contiguous(), p.contiguous(), meta.gid,
                            meta.pair_src, *w)
    # combine: a collision-free gather by pair, then the K-sum
    pair_y = y.index_select(0, meta.dest_aligned)
    return pair_y.reshape(n, k, h).sum(dim=1).to(x.dtype)


class FusedMoEFFN(torch.autograd.Function):
    """Differentiable fused expert FFN (counterpart of the ``custom_vjp``
    ``fused_moe_ffn``). The forward runs the selected kernel on detached
    tensors. The backward recomputes :func:`reference_apply` under
    ``torch.enable_grad()`` and differentiates it: this is the reference's
    own backward (the TPU kernels have none), not a fallback. Saved tensors
    are the function's inputs; the routing gets no gradient."""

    @staticmethod
    def forward(ctx, x, probs, gate_w, up_w, down_w, sort_idx, dest,
                token_idx, group_sizes, num_experts, gather, combine,
                block_m):
        sort = TokenSort(sort_idx, dest, token_idx, group_sizes)
        out = _fused_forward(x.detach(), probs.detach(), gate_w.detach(),
                             up_w.detach(), down_w.detach(), sort,
                             num_experts, gather, combine, block_m)
        ctx.save_for_backward(x, probs, gate_w, up_w, down_w, sort_idx, dest,
                              token_idx, group_sizes)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, probs, gate_w, up_w, down_w, *sort = ctx.saved_tensors
        sort = TokenSort(*sort)
        inputs = [t.detach().requires_grad_(need) for t, need in zip(
            (x, probs, gate_w, up_w, down_w), ctx.needs_input_grad[:5])]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = reference_apply(inputs[0], inputs[1], sort, *inputs[2:],
                                      gate_w.dtype)
            grads = iter(torch.autograd.grad(out, wanted, d_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None, None, None, None, None)


def _block_m_for(x, dtype, h, inter, block_m):
    if x.device.type == "cpu":
        return PLAIN_BLOCK_M if block_m is None else block_m
    if x.device.type != "cuda":
        raise _no_kernel("fused_moe_ffn_apply", x.device)
    bm = kernel_block_m(dtype, h, inter)
    if block_m is not None and block_m != bm:
        raise ValueError(
            f"fused_moe_ffn_apply: block_m {block_m} asked for, the kernel "
            f"takes {bm} rows per tile in {dtype}")
    return bm


def fused_moe_ffn_apply(
    x: torch.Tensor,
    probs: torch.Tensor,
    sort: TokenSort,
    gate_w: torch.Tensor,
    up_w: torch.Tensor,
    down_w: torch.Tensor,
    dtype: torch.dtype,
    *,
    num_experts: int,
    gather: bool = False,
    combine: bool = False,
    block_m: int | None = None,
) -> torch.Tensor:
    """``x [N, h]`` tokens + routing (``probs [N, K]``, ``sort``) → combined
    expert outputs ``[N, h]`` in ``x``'s dtype, differentiable. Weights are
    cast to the compute ``dtype`` first, as in the JAX package.

    ``gather=False``: the aligned kernel (B5) on a gathered aligned buffer;
    ``gather=True``: the gather kernel (B6); ``gather=True, combine=True``:
    the gather + combine kernel (B7). ``combine`` without ``gather`` raises.
    ``block_m``: CPU tensors take any (default :data:`PLAIN_BLOCK_M`); CUDA
    tensors take the kernel's and raise on another.
    """
    if combine and not gather:
        raise ValueError("fused_moe_ffn_apply: combine needs gather")
    h, inter = gate_w.shape[-2], gate_w.shape[-1]
    bm = _block_m_for(x, dtype, h, inter, block_m)
    return FusedMoEFFN.apply(
        x, probs, gate_w.to(dtype), up_w.to(dtype), down_w.to(dtype),
        sort.sort_idx, sort.dest, sort.token_idx, sort.group_sizes,
        num_experts, gather, combine, bm)


__all__ = [
    "AlignedMeta",
    "FusedMoEFFN",
    "KERNEL_WIDTH_MULTIPLE",
    "MOE_FFN_VARIANTS",
    "PLAIN_BLOCK_M",
    "aligned_metadata",
    "check_ffn_inputs",
    "fused_moe_ffn_apply",
    "kernel_block_m",
    "moe_ffn_aligned",
    "moe_ffn_aligned_plain",
    "moe_ffn_gather",
    "moe_ffn_gather_combine",
    "moe_ffn_gather_combine_plain",
    "moe_ffn_gather_plain",
    "reference_apply",
]
