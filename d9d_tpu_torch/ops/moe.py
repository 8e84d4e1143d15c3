"""MoE token routing and permutation ops and the grouped matmul (counterpart
of ``d9d_tpu/ops/moe.py``).

All functions work on a flat token dim; callers reshape ``[B,T,D]`` to
``[N,D]``. Index tensors are int64 (what PyTorch's gathers and scatters
take); their values equal the JAX package's int32 ones.

The stable grouping is ONE formulation here, a stable argsort: both
branches of the JAX ``stable_expert_order`` compute exactly
``argsort(ids, stable=True)`` (its one-hot branch is a TPU speed choice).
Nothing in this module reads a device value back, except
:func:`group_sizes_on_host`, which the grouped matmuls take their row
slices from and which counts its readbacks.
"""

from typing import NamedTuple, Sequence

import torch

from d9d_tpu_torch.ops.swiglu import silu_mul


class TokenSort(NamedTuple):
    """(token, choice) pairs sorted by expert.

    sort_idx: ``[N*K]`` pair (token-major flat index) of each sorted row.
    dest: ``[N*K]`` inverse permutation: where pair i lands in the sorted
        layout (``dest[sort_idx[r]] == r``).
    token_idx: ``[N*K]`` owning token of each sorted row (``sort_idx // K``).
    group_sizes: ``[E]`` rows per expert, in sorted order.
    """

    sort_idx: torch.Tensor
    dest: torch.Tensor
    token_idx: torch.Tensor
    group_sizes: torch.Tensor


def stable_expert_order(
    flat_ids: torch.Tensor, num_experts: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sort_idx [M], dest [M], group_sizes [E])``: the stable grouping
    permutation of ``flat_ids`` (original order kept inside each expert),
    its inverse, and the rows per expert. The counts come from a
    ``scatter_add_`` (``torch.bincount`` on a CUDA tensor reads its maximum
    back to the host)."""
    ids = flat_ids.to(torch.int64)
    m = ids.shape[0]
    sort_idx = torch.argsort(ids, stable=True)
    arange = torch.arange(m, dtype=torch.int64, device=ids.device)
    dest = torch.empty_like(sort_idx).scatter_(0, sort_idx, arange)
    group_sizes = torch.zeros(
        num_experts, dtype=torch.int64, device=ids.device
    ).scatter_add_(0, ids, torch.ones_like(ids))
    return sort_idx, dest, group_sizes


def sort_tokens_by_expert(topk_ids: torch.Tensor, num_experts: int) -> TokenSort:
    """Stable-sort the (token, k) pairs of ``topk_ids [N, K]`` by expert."""
    n, k = topk_ids.shape
    sort_idx, dest, group_sizes = stable_expert_order(
        topk_ids.reshape(n * k), num_experts)
    return TokenSort(sort_idx=sort_idx, dest=dest, token_idx=sort_idx // k,
                     group_sizes=group_sizes)


def pair_rows(x: torch.Tensor, k: int, pairs: torch.Tensor) -> torch.Tensor:
    """Rows ``pairs`` (token-major flat pair indices, each at most once) of
    the tokens ``x [N, D]`` repeated ``k`` times: token ``p // k`` for pair
    ``p``. The values of a gather by token, but not its backward: that one
    adds each token's row gradients by atomics in the order they land on a
    card, which changes the bits from run to run once a token has three or
    more (top-k >= 3). This backward is a collision-free gather and a sum
    over each token's k pairs in a fixed order, the same on every run."""
    n, d = x.shape
    return x.unsqueeze(1).expand(n, k, d).reshape(n * k, d).index_select(
        0, pairs)


def permute_tokens(
    x: torch.Tensor, probs: torch.Tensor, sort: TokenSort
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens and their routing probs in expert-sorted layout:
    ``x [N, D]``, ``probs [N, K]`` → ``([N*K, D], [N*K])`` (the rows by
    :func:`pair_rows`)."""
    k = sort.sort_idx.shape[0] // x.shape[0]
    return (pair_rows(x, k, sort.sort_idx),
            probs.reshape(-1).index_select(0, sort.sort_idx))


def combine_pairs(y: torch.Tensor, dest: torch.Tensor,
                  num_tokens: int) -> torch.Tensor:
    """Fold expert-sorted, prob-weighted pair rows ``y [N*K, D]`` back to
    their tokens ``[N, D]``: a gather by ``dest`` (a permutation, so no
    index collides) and a sum over the K rows of each token."""
    k = dest.shape[0] // num_tokens
    return y.index_select(0, dest).reshape(num_tokens, k, y.shape[-1]).sum(1)


def unpermute_combine(y: torch.Tensor, sort: TokenSort,
                      num_tokens: int) -> torch.Tensor:
    """The reverse of :func:`permute_tokens` (see :func:`combine_pairs`)."""
    return combine_pairs(y, sort.dest, num_tokens)


def group_sizes_on_host(group_sizes: torch.Tensor) -> list[int]:
    """The rows of each expert as host ints: ONE device-to-host readback,
    counted in ``group_sizes_on_host.readbacks``. The grouped matmuls slice
    their rows by these."""
    group_sizes_on_host.readbacks += 1
    return [int(s) for s in group_sizes.tolist()]


group_sizes_on_host.readbacks = 0


def _as_sizes(group_sizes) -> list[int]:
    if isinstance(group_sizes, torch.Tensor):
        return group_sizes_on_host(group_sizes)
    return list(group_sizes)


def grouped_matmul(
    x: torch.Tensor, weight: torch.Tensor,
    group_sizes: "torch.Tensor | Sequence[int]",
) -> torch.Tensor:
    """Per-expert product on expert-sorted rows: ``x [rows, in]``, ``weight
    [E, in, out]`` → ``[rows, out]`` in ``x``'s dtype (``lax.ragged_dot``
    with ``preferred_element_type=x.dtype``). Rows past ``sum(group_sizes)``
    come out zero. A plain product per expert slice, as the JAX package
    leaves it to XLA; ``group_sizes`` given as a tensor costs one readback
    (pass host ints to share one readback between several products).

    The slices are taken by one ``split`` of the rows and one ``unbind`` of
    the experts: their backward writes each gradient once (a ``cat``, a
    ``stack``). Indexing ``x[a:b]`` / ``weight[e]`` per expert would give
    every expert's gradient a zero-filled full-size buffer of its own — E
    full copies of the weight stack per product."""
    sizes = _as_sizes(group_sizes)
    tail = x.shape[0] - sum(sizes)
    rows = x.split(sizes + [tail])
    experts = weight.unbind(0)
    outs = [rows[e] @ experts[e] for e, size in enumerate(sizes) if size]
    if tail or not outs:
        outs.append(x.new_zeros((tail, weight.shape[-1])))
    return torch.cat(outs, dim=0)


def gate_up_grouped_matmul(
    x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
    group_sizes: "torch.Tensor | Sequence[int]",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate and up projections of expert-sorted rows → ``(g, u)``, both
    from one readback of the group sizes. The JAX package's default runs
    them as one ragged product over a runtime ``[E, in, 2*inter]`` weight
    concat; every output column is the same dot product either way, so the
    port keeps the two weights apart and skips the concat. Weights must
    already be in the compute dtype."""
    sizes = _as_sizes(group_sizes)
    return (grouped_matmul(x, gate_w, sizes), grouped_matmul(x, up_w, sizes))


def grouped_swiglu_apply(
    permuted_x: torch.Tensor, permuted_probs: torch.Tensor,
    group_sizes: "torch.Tensor | Sequence[int]", gate_w: torch.Tensor,
    up_w: torch.Tensor, down_w: torch.Tensor, dtype: torch.dtype,
) -> torch.Tensor:
    """The experts' SwiGLU on expert-sorted rows ``[M, D]`` with their
    probs ``[M]`` → prob-weighted outputs ``[M, D]`` in ``dtype``: grouped
    gate/up products, ``silu(g) * u``, grouped down product, × probs — the
    XLA chain of the JAX package (``nn/moe.py`` ``grouped_swiglu_apply``),
    one readback of the group sizes when given as a tensor."""
    sizes = _as_sizes(group_sizes)
    g, u = gate_up_grouped_matmul(permuted_x.to(dtype), gate_w.to(dtype),
                                  up_w.to(dtype), sizes)
    out = grouped_matmul(silu_mul(g, u), down_w.to(dtype), sizes)
    return out * permuted_probs[:, None].to(dtype)


__all__ = [
    "TokenSort",
    "combine_pairs",
    "gate_up_grouped_matmul",
    "group_sizes_on_host",
    "grouped_matmul",
    "grouped_swiglu_apply",
    "pair_rows",
    "permute_tokens",
    "sort_tokens_by_expert",
    "stable_expert_order",
    "unpermute_combine",
]
