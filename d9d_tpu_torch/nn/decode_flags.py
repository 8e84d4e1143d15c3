"""Decode-phase flag for chunked prefill and the paged-cache names
(counterpart of ``d9d_tpu/nn/decode_flags.py``; the port keeps its own
copy).

Chunked prefill (``loop/generate.py`` ``prefill_chunk_size``) feeds a long
prompt through the decode cache in bounded pieces. Whether a multi-token
call is the FIRST chunk (empty cache — the flash prefill fast path applies)
or a CONTINUATION (the new tokens must attend the slot cache) is knowledge
the caller has and the attention module needs, while the cache write index
lives on the device; so the fact travels as a context flag, not data.
``generate()`` wraps continuation-chunk calls in :func:`continuation_chunk`;
attention modules read :func:`in_continuation_chunk`.
"""

import contextlib
import contextvars

_continuation = contextvars.ContextVar(
    "d9d_tpu_torch_decode_continuation", default=False
)


@contextlib.contextmanager
def continuation_chunk():
    """Mark model calls in this block as continuation prefill chunks:
    multi-token decode-mode calls attend the slot cache (valid at any cache
    index) instead of taking the empty-cache prefill fast path."""
    token = _continuation.set(True)
    try:
        yield
    finally:
        _continuation.reset(token)


def in_continuation_chunk() -> bool:
    return _continuation.get()


# -- paged KV cache plumbing ----------------------------------------------
#
# The JAX package keeps its decode cache in a flax collection and finds the
# paged leaves by name; the port keeps it in a torch object
# (``nn/attention.py`` ``PagedDecodeCache``) whose attributes carry the same
# roles. The names stay so that a reader finds the counterpart.

# cache leaves that hold per-token sequence content and can be paged:
# leaf name → axis that indexes cache slots in the DENSE layout. Paged mode
# turns each into a pool with a leading page axis and the slot axis shrunk
# to page_size (GQA heads-major [B, Hkv, S, D] → [P, Hkv, page_size, D]).
# The MLA leaves are listed for parity; MLA is not ported yet.
PAGED_CACHE_LEAVES = {
    "cached_key": 2,       # GQA heads-major [B, Hkv, S, D]
    "cached_value": 2,
    "cached_latent": 1,    # MLA [B, S, r]
    "cached_rope_key": 1,  # MLA [B, S, d_rope]
}

PAGE_TABLE_LEAF = "page_table"

# an int8 pool leaf has a sibling ``<leaf>_scale`` pool holding one f32
# dequantization scale per (page, [head,] slot): the pool shape minus its
# trailing feature dim, indexed through the SAME page table
PAGED_SCALE_SUFFIX = "_scale"


def paged_pool_shape(dense_shape, leaf: str, num_pages: int,
                     page_size: int) -> tuple:
    """Pool shape of paged leaf ``leaf`` whose dense shape is
    ``dense_shape``: a leading page axis, the slot axis shrunk to
    ``page_size``, the batch axis gone."""
    axis = PAGED_CACHE_LEAVES[leaf]
    return ((num_pages,) + tuple(dense_shape[1:axis]) + (page_size,)
            + tuple(dense_shape[axis + 1:]))


def map_page_table(cache, fn):
    """Write ``fn(table)`` over the ``page_table`` of a decode cache, IN
    PLACE (the serving loop pins dead rows' tables to the garbage page and
    pushes its host mirror with it; a pinned host result is copied
    asynchronously). No-op on an unpaged cache."""
    table = getattr(cache, PAGE_TABLE_LEAF, None)
    if table is not None:
        table.copy_(fn(table), non_blocking=True)
    return cache
