"""Decode-phase flag for chunked prefill (counterpart of the
``continuation_chunk`` / ``in_continuation_chunk`` pair of
``d9d_tpu/nn/decode_flags.py``; the port keeps its own copy).

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
