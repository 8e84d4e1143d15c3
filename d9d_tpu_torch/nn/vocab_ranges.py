"""Shared named-vocab-range parameter handling (counterpart of
``d9d_tpu/nn/vocab_ranges.py``).

Both the token embedding and the LM head declare the vocabulary as an
ordered tuple of named ranges. The JAX package keeps one parameter per range
and concatenates them at every use; the port concatenates ONCE, when weights
are loaded (``model_state/from_jax.py`` uses :func:`concat_vocab_ranges` in
range order), and holds a single ``[vocab, hidden]`` table — a per-call
concat would copy the whole table every decode step.
"""

import torch

VocabRanges = tuple[tuple[str, int], ...]


def vocab_range_names(prefix: str, vocab_ranges: VocabRanges) -> list[str]:
    """Parameter names of the per-range tables in the JAX package's tree,
    in concat order (``embedding_text``, ``embedding_special``, …)."""
    return [f"{prefix}_{name}" for name, _ in vocab_ranges]


def vocab_size(vocab_ranges: VocabRanges) -> int:
    return sum(size for _, size in vocab_ranges)


def concat_vocab_ranges(tables: list[torch.Tensor]) -> torch.Tensor:
    return tables[0] if len(tables) == 1 else torch.cat(tables, dim=0)
