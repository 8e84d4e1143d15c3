"""Batch padding/stacking and pooling-mask utilities (counterpart of
``d9d_tpu/dataset/padding.py``, a copy): ``pad_stack_1d`` with left/right
side and pad-to-multiple, and ``token_pooling_mask_from_attention_mask``
(first/last/all). numpy-native: collation happens on the host before the
batch is staged onto the device."""

from collections.abc import Sequence
from enum import Enum

import numpy as np


class PaddingSide1D(str, Enum):
    left = "left"
    right = "right"


def pad_stack_1d(
    items: Sequence[np.ndarray],
    pad_value: int,
    padding_side: PaddingSide1D = PaddingSide1D.right,
    pad_to_multiple_of: int | None = None,
) -> np.ndarray:
    """Stack 1D arrays into [batch, max_len], padding to the longest
    (optionally rounded up to a multiple)."""
    if not items:
        raise ValueError("Cannot stack 0 items")
    if pad_to_multiple_of is not None and pad_to_multiple_of <= 0:
        raise ValueError("pad_to_multiple_of should be > 0")

    max_len = max(x.shape[0] for x in items)
    if pad_to_multiple_of is not None:
        remainder = max_len % pad_to_multiple_of
        if remainder != 0:
            max_len += pad_to_multiple_of - remainder

    out = np.full((len(items), max_len), pad_value, dtype=np.asarray(items[0]).dtype)
    for i, x in enumerate(items):
        x = np.asarray(x)
        if padding_side == PaddingSide1D.right:
            out[i, : x.shape[0]] = x
        elif padding_side == PaddingSide1D.left:
            out[i, max_len - x.shape[0] :] = x
        else:
            raise ValueError("Unknown padding side")
    return out


class TokenPoolingType(str, Enum):
    first = "first"
    last = "last"
    all = "all"


def token_pooling_mask_from_attention_mask(
    attention_mask: np.ndarray, pooling_type: TokenPoolingType
) -> np.ndarray:
    """Binary [B, T] mask selecting tokens to pool (CLS / last non-pad / all)."""
    attention_mask = np.asarray(attention_mask)
    match pooling_type:
        case TokenPoolingType.first:
            mask = np.zeros_like(attention_mask, dtype=np.int64)
            mask[:, 0] = 1
            return mask
        case TokenPoolingType.last:
            batch_indices = np.arange(attention_mask.shape[0])
            last_token = attention_mask.sum(axis=1) - 1
            mask = np.zeros_like(attention_mask, dtype=np.int64)
            mask[batch_indices, last_token] = 1
            return mask
        case TokenPoolingType.all:
            return attention_mask.astype(np.int64)
    raise ValueError(f"Unknown pooling type: {pooling_type}")
