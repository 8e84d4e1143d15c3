"""Autoregressive generation over KV-cache decode models (counterpart of
``d9d_tpu/loop/generate.py``).

Build a model with ``decode_max_length >= prompt_len + max_new_tokens - 1``
and this module runs prefill plus a decode loop. Where the JAX function
traces a ``lax.scan``, the port runs a Python loop of eager steps; every
token stays on the device until the loop has finished, and no step reads a
device value back to the host.

The cache is a :class:`~d9d_tpu_torch.nn.attention.DecodeCache` this
function creates through ``model.init_cache`` and the model updates in
place.

Ragged batches are LEFT-padded: pass ``prompt_lengths [B]`` and rows shorter
than the padded width get per-row rope positions (``0..L-1`` right-aligned)
plus a key-validity mask over their pad slots (cache-slot order equals time
order per row, so causality stays slot-based).

Sampling: ``temperature=0`` is greedy argmax; otherwise a categorical draw
over ``logits / temperature`` from an explicit ``torch.Generator``,
optionally truncated to the ``top_k`` highest-probability tokens and/or the
smallest set with cumulative probability ``top_p`` (both given = top-k
first, then nucleus over the survivors). The draws differ from the JAX
package's for the same seed (another generator); the filtered logits are
the same. ``eos_id`` freezes finished rows (they keep emitting ``eos_id``
so shapes stay static).
"""

from typing import Optional

import torch

from d9d_tpu_torch.nn.decode_flags import continuation_chunk
from d9d_tpu_torch.nn.moe import expert_parallel_layers


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask logits below the k-th largest to -inf."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(
        logits >= kth, logits, torch.full_like(logits, float("-inf"))
    )


def _nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest cumulative-``top_p`` set to -inf
    (the most probable token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while the cumulative mass BEFORE them is < top_p
    keep_sorted = (cum - probs) < top_p
    cutoff = torch.where(
        keep_sorted, sorted_logits,
        torch.full_like(sorted_logits, float("inf")),
    ).amin(dim=-1, keepdim=True)
    return torch.where(
        logits >= cutoff, logits, torch.full_like(logits, float("-inf"))
    )


def sample_tokens(
    logits: torch.Tensor,
    *,
    temperature: float,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``logits [B, V]`` → int32 token ids ``[B]`` (greedy at temperature
    0, else a categorical draw over the filtered, tempered logits)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        scaled = _top_k_filter(scaled, top_k)
    if top_p is not None and top_p < 1.0:
        scaled = _nucleus_filter(scaled, top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def refuse_expert_parallel(model, entry: str) -> None:
    """Serving has no mesh: a model whose MoE layers were built with
    ``ep_axes`` raises (ROADMAP A10)."""
    layers = expert_parallel_layers(model)
    if layers:
        raise NotImplementedError(
            f"{entry}: serving a model built with ep_axes ({layers[0]}, ...) "
            f"is not ported (ROADMAP A10); build it with ep_axes=None")


@torch.no_grad()
def generate(
    model,
    prompt_ids: torch.Tensor,
    *,
    max_new_tokens: int,
    prompt_lengths: Optional[torch.Tensor] = None,
    temperature: float = 0.0,
    top_p: float | None = None,
    top_k: int | None = None,
    generator: Optional[torch.Generator] = None,
    eos_id: int | None = None,
    prefill_chunk_size: int | None = None,
) -> torch.Tensor:
    """``prompt_ids [B, P]`` int → generated ids ``[B, max_new_tokens]``
    (int32, on the model's device).

    ``model`` must be built with
    ``decode_max_length >= P + max_new_tokens - 1`` (the final sampled token
    is returned, never fed back). Inputs are moved to the model's device.
    Ragged batches: left-pad to width P and pass ``prompt_lengths [B]``.

    ``prefill_chunk_size``: feed the prompt through the cache in chunks of
    at most this many tokens (prefill activation memory stays O(chunk)
    instead of O(P)). The first chunk runs the flash prefill fast path on
    the empty cache; continuation chunks attend the slot cache through the
    flash-decode kernel, whatever their size — results are exact, not
    approximate.
    """
    refuse_expert_parallel(model, "generate")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 needs a torch.Generator")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if (top_p is not None or top_k is not None) and temperature == 0.0:
        raise ValueError(
            "top_p/top_k have no effect with temperature=0 (greedy "
            "argmax); set a temperature to sample"
        )
    if prefill_chunk_size is not None and prefill_chunk_size < 1:
        raise ValueError(
            f"prefill_chunk_size must be >= 1, got {prefill_chunk_size}"
        )
    dml = getattr(model, "decode_max_length", 0)
    b, p = prompt_ids.shape
    # the final sampled token is returned, never fed back, so the cache
    # holds at most p + max_new_tokens - 1 positions. This static check is
    # the capacity contract: no layer checks the device-side index.
    if dml < p + max_new_tokens - 1:
        raise ValueError(
            f"model.decode_max_length={dml} < prompt {p} + "
            f"max_new_tokens {max_new_tokens} - 1"
        )
    dev = model.device
    ids = prompt_ids.to(device=dev, dtype=torch.int64)

    def sample(logits):
        return sample_tokens(
            logits, temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator,
        )

    # per-row geometry: row i's real tokens sit right-aligned in
    # [pad_i, P) with pad_i = P - L_i; logical positions are 0..L_i-1
    if prompt_lengths is not None:
        lengths = prompt_lengths.to(device=dev, dtype=torch.int32)
        pad = p - lengths  # [B]
        positions = torch.clamp(
            torch.arange(p, dtype=torch.int32, device=dev)[None, :]
            - pad[:, None],
            min=0,
        )
        key_valid = (
            torch.arange(dml, dtype=torch.int32, device=dev)[None, :]
            >= pad[:, None]
        )[:, None, None, :]  # [B,1,1,S_max]; decode slots (>= P) valid
    else:
        lengths = torch.full((b,), p, dtype=torch.int32, device=dev)
        positions = torch.broadcast_to(
            torch.arange(p, dtype=torch.int32, device=dev), (b, p)
        )
        key_valid = None

    # the cache starts empty here, which is what makes the first chunk's
    # multi-token fast path valid (the empty-cache contract, held statically)
    cache = model.init_cache(b)

    # prefill: write every layer's cache; only the last position's logits
    # are needed. With a chunk size the prompt streams through in bounded
    # pieces — chunk 0 on the empty cache (fast path), the rest as
    # slot-cache continuation chunks.
    chunk = prefill_chunk_size if prefill_chunk_size is not None else p
    logits = model.logits_last(
        ids[:, :chunk], positions[:, :chunk], mask=key_valid, cache=cache
    )
    for lo in range(chunk, p, chunk):
        hi = min(lo + chunk, p)
        with continuation_chunk():
            logits = model.logits_last(
                ids[:, lo:hi], positions[:, lo:hi], mask=key_valid,
                cache=cache,
            )
    token = sample(logits[:, -1])
    tokens = [token]
    if eos_id is not None:
        done = token == eos_id
    pos = lengths
    for _ in range(max_new_tokens - 1):
        logits_t = model.logits_last(
            token[:, None].to(torch.int64), pos[:, None], mask=key_valid,
            cache=cache,
        )
        nxt = sample(logits_t[:, -1])
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        token = nxt
        pos = pos + 1
        tokens.append(token)
    # prefill sampled the first generated token; each step the next one
    return torch.stack(tokens, dim=1)
