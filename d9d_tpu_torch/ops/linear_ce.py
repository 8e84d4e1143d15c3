"""Fused linear + cross-entropy that never holds the full logit matrix
(counterpart of ``d9d_tpu/ops/linear_ce.py``).

The LM-head product and the CE loss run one token chunk at a time. With more
than one chunk, each chunk runs under ``torch.utils.checkpoint``, the
counterpart of the JAX package's ``jax.checkpoint`` per chunk: the backward
recomputes a chunk's ``[C, V]`` logits instead of storing them, so the
``[N, V]`` logits (2.5 GB in fp32 at N = 4096, V = 151936) never live at
once. Plain PyTorch: the JAX package leaves this op to XLA.

Vocab-parallel (``group``): ``weight`` is this rank's rows of the table,
from ``vocab_start`` on. Per chunk the rank takes its local logits; the
row max and the sum of exps are reduced over the group, and the target
logit is taken where the label falls in the rank's rows and summed over
the group (one sum for both), so every rank holds every token's loss. The
hidden state enters through ``copy_to_group`` (its gradient, each rank's
part over its rows, summed over the group); each rank's table gradient is
its own rows'. The table is never gathered.
"""

import functools

import torch
from torch.utils.checkpoint import checkpoint

from d9d_tpu_torch.core.collectives import (
    all_reduce_max_,
    copy_to_group,
    reduce_from_group,
)

LM_IGNORE_INDEX = -100

# auto chunking: one chunk up to this many tokens, and only while the live
# logit slab stays within 2048 tokens x 32768 vocab; larger n*V keeps
# chunking at 512 tokens (the JAX package's rule, linear_ce.py:66-67)
_AUTO_SINGLE_CHUNK_MAX = 2048
_AUTO_SINGLE_CHUNK_MAX_LOGITS = 2048 * 32_768
_AUTO_CHUNK = 512

_MATMUL_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _chunk_loss(
    hidden: torch.Tensor,
    labels: torch.Tensor,
    weight: torch.Tensor,
    logit_softcap: float | None,
    matmul_dtype: str,
    vocab_start: int = 0,
    group=None,
) -> torch.Tensor:
    """Per-token loss of one chunk: ``hidden [C, D]``, ``labels [C]``,
    ``weight [V, D]`` (the rank's ``V`` rows from ``vocab_start`` on, under
    ``group``) → fp32 ``[C]``.

    Both operands are rounded to the matmul dtype and the product is taken
    in fp32, which is what the JAX package's ``preferred_element_type=
    float32`` asks for: bf16 inputs, fp32 accumulation, fp32 logits. (A
    bf16 product widened afterwards would round the logits to bf16.) The
    softmax / logsumexp math is fp32 either way.
    """
    mm = _MATMUL_DTYPES[matmul_dtype]
    logits = hidden.to(mm).float() @ weight.to(mm).float().T
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        safe = labels.clamp(0, logits.shape[-1] - 1).long()
        correct = torch.gather(logits, 1, safe[:, None])[:, 0]
    else:
        top = all_reduce_max_(logits.detach().amax(dim=-1), group)
        local = labels.long() - vocab_start
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = torch.gather(logits, 1,
                              torch.where(inside, local, 0)[:, None])[:, 0]
        sums = reduce_from_group(torch.stack([
            torch.exp(logits - top[:, None]).sum(dim=-1),
            torch.where(inside, picked, 0.0)]), group)
        lse = top + torch.log(sums[0])
        correct = sums[1]
    loss = lse - correct
    return torch.where(labels == LM_IGNORE_INDEX, torch.zeros_like(loss), loss)


def resolve_chunk_size(n: int, vocab: int, chunk_size: "int | str") -> int:
    """``"auto"`` → one chunk of ``n`` while ``n <= 2048`` and ``n * V <=
    2048 * 32768``, else 512; an int is taken as it is."""
    if chunk_size == "auto":
        single = (n <= _AUTO_SINGLE_CHUNK_MAX
                  and n * vocab <= _AUTO_SINGLE_CHUNK_MAX_LOGITS)
        return n if single else _AUTO_CHUNK
    return int(chunk_size)


def linear_cross_entropy(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: "int | str" = "auto",
    logit_softcap: float | None = None,
    matmul_dtype: str | None = None,
    vocab_start: int = 0,
    group=None,
) -> torch.Tensor:
    """Per-token CE of ``hidden [N, D] @ weight [V, D].T`` against ``labels
    [N]`` → fp32 ``[N]``; tokens labelled ``-100`` contribute zero loss.
    With ``group``, ``weight`` is this rank's rows of a vocab-parallel
    table, from ``vocab_start`` on (see the module docstring); the chunk
    size follows the rank's rows.

    ``matmul_dtype`` (``"bf16"`` / ``"fp32"``) defaults to ``"bf16"`` for
    bf16 ``hidden`` and ``"fp32"`` otherwise, as in the JAX package.
    Reduction and weighting are the caller's.
    """
    if matmul_dtype is None:
        matmul_dtype = "bf16" if hidden.dtype == torch.bfloat16 else "fp32"
    if matmul_dtype not in _MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be 'bf16' or 'fp32', got "
                         f"{matmul_dtype!r}")
    n, d = hidden.shape
    hidden = copy_to_group(hidden, group)
    chunk = resolve_chunk_size(n, weight.shape[0], chunk_size)
    body = functools.partial(
        _chunk_loss, logit_softcap=logit_softcap, matmul_dtype=matmul_dtype,
        vocab_start=vocab_start, group=group)
    if n <= chunk:
        return body(hidden, labels, weight)

    pad = (-n) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros((pad, d))])
        labels = torch.cat(
            [labels, labels.new_full((pad,), LM_IGNORE_INDEX)])
    losses = []
    for lo in range(0, n + pad, chunk):
        h, l = hidden[lo:lo + chunk], labels[lo:lo + chunk]
        if torch.is_grad_enabled():
            losses.append(checkpoint(body, h, l, weight, use_reentrant=False))
        else:
            losses.append(body(h, l, weight))
    return torch.cat(losses)[:n]


__all__ = ["LM_IGNORE_INDEX", "linear_cross_entropy", "resolve_chunk_size"]
