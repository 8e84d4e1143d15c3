"""Continuous batching: a slot-based serving loop over decode models
(counterpart of ``ContinuousBatcher`` in ``d9d_tpu/loop/serve.py``, in its
CONTIGUOUS cache mode and its PAGED mode with the prefix cache and int8 KV).

``ContinuousBatcher`` keeps a fixed batch of ``batch_size`` slots decoding;
requests are admitted into free slots as they arrive and evicted on
EOS/budget — rows never wait for each other (iteration-level scheduling).

Host-interaction contract (the design decision that defines performance):
the inner decode loop is FUSED — ``chunk_size`` (K) single-token steps are
enqueued back to back, advance all slots, apply per-row stop/length masks in
device tensors and accumulate emitted tokens into a device-side ``[B, K]``
buffer. The host uploads ONE plan and performs ONE token readback per K
generated tokens instead of per token; admission, eviction and finished-row
harvesting happen only at chunk boundaries. Where the JAX batcher traces a
``lax.scan`` into one executable, the port runs a Python loop of eager
steps with no host synchronization inside; the readback is an asynchronous
copy into pinned memory that the harvest waits on. Rows that finish
mid-chunk (budget or EOS) are masked dead on the device — their emissions
stop and their write index pins to 0 the same step — and are harvested at
the boundary. ``drain()`` double-buffers: while no admissions are waiting,
chunk N+1 is enqueued before chunk N's tokens are fetched.

``chunk_size=None`` selects the per-token stepping path (one dispatch + one
readback per token) — the oracle for the fused path's exactness tests.

Admission is TOKEN-LEVEL: the loop always processes exactly one token per
slot per device step. A newly admitted request spends its first
``len(prompt)`` steps consuming its prompt (teacher-forced through the same
decode step), then flips to generation.

Per-row cache state: the batcher owns a
:class:`~d9d_tpu_torch.nn.attention.DecodeCache` with a PER-ROW ``[B]``
write index, updated in place; the flash-decode kernel takes per-row
``start`` offsets natively. Row admission zeroes just that row's cache
slice. Idle and dead rows have their write index pinned to 0 every step, so
a slot left idle for arbitrarily many steps can never run past capacity or
defeat the flash-decode block skip.

Paged KV cache + prefix cache: with ``page_size`` set, the sequence caches
become page POOLS ``[num_pages, Hkv, page_size, D]`` per layer, read and
written through one per-row ``[B, pages_per_row]`` page table
(:class:`~d9d_tpu_torch.nn.attention.PagedDecodeCache`): KV memory per
request is proportional to its actual length, admission is bounded by free
pages (the queue head waits, it is never rejected), and a content-hashed
prefix cache maps a shared prompt's full pages copy-on-write into later
requests, which skip feeding them. All policy (free lists, refcounts,
hashing, LRU eviction — ``loop/kv_paging.py``) runs on the host at the chunk
boundaries admission already owns; the table reaches the device as one
asynchronous upload from pinned memory at a clean boundary, so paging adds
no dispatch and no readback. Each step pins dead and idle rows' tables to
the garbage page 0. ``kv_quant="int8"`` stores the pools as int8 with f32
per-slot scales beside them; writes quantize, the paged flash-decode kernel
dequantizes. Greedy paged serving is token-identical to the contiguous
layout, prefix hit or cold; int8 KV is drift-bounded instead.

Parity contract: greedy serving of any admission schedule emits, per
request, exactly the tokens ``generate(model, prompt)`` produces.

Not ported yet (absent, or raising ``NotImplementedError``): live weight
publish (and with it the prefix cache's invalidation), export/import of KV
pages, deadlines, bounded queues and the stall watchdog, telemetry / metrics
server / trace ids, and the serving fleet.
"""

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from d9d_tpu_torch.loop.generate import refuse_expert_parallel, sample_tokens
from d9d_tpu_torch.loop.kv_paging import PagedKVAllocator


@dataclasses.dataclass
class _Slot:
    rid: int = -1            # active request id, -1 = idle
    # per-token mode: prompt tokens after the one in _tokens
    pending: list = dataclasses.field(default_factory=list)
    pos: int = 0             # per-token mode: next rope position of the row
    # fused mode: prompt tokens not yet dispatched as step inputs
    feed: list = dataclasses.field(default_factory=list)
    emitted: int = 0         # committed (harvested) emissions
    budget: int = 0          # max_new_tokens for the active request


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: list
    max_new_tokens: int

    @property
    def total_tokens(self) -> int:
        """Cache slots this request writes over its lifetime: every prompt
        token plus every generated token except the final sample (emitted
        but never fed back) — the footprint submit validation and page
        allocation both key on."""
        return len(self.prompt) + self.max_new_tokens - 1


@dataclasses.dataclass
class _ChunkPlan:
    """Host-side record of one dispatched fused chunk, consumed FIFO at
    harvest time: enough to replay the device's emission/stop logic on the
    readback without fetching any mask buffers."""

    k: int
    rids: list            # rid per slot at dispatch (-1 = idle)
    emit_from: list       # first step index (within the chunk) that emits


@dataclasses.dataclass
class ServeStats:
    """Host-interaction and utilization counters (reset with ``reset()``).

    ``host_dispatches`` counts dispatches (one per fused chunk, per-token
    step or row reset — the quantity the fused loop divides by K);
    ``readbacks`` counts device→host token fetches; ``device_steps`` counts
    single-token decode steps executed on the device;
    ``slot_steps_busy / slot_steps_total`` give slot occupancy (busy
    includes prompt-consumption steps).
    """

    host_dispatches: int = 0
    readbacks: int = 0
    chunks: int = 0
    device_steps: int = 0
    emitted_tokens: int = 0
    slot_steps_busy: int = 0
    slot_steps_total: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    @property
    def dispatches_per_1k_tokens(self) -> float:
        if self.emitted_tokens == 0:
            return float("inf")
        return 1000.0 * self.host_dispatches / self.emitted_tokens

    @property
    def readbacks_per_1k_tokens(self) -> float:
        if self.emitted_tokens == 0:
            return float("inf")
        return 1000.0 * self.readbacks / self.emitted_tokens

    @property
    def slot_utilization(self) -> float:
        if self.slot_steps_total == 0:
            return 0.0
        return self.slot_steps_busy / self.slot_steps_total


class _Readback:
    """One asynchronous device→host fetch of a token buffer. On a CUDA
    device the copy is enqueued right behind the work that produced the
    buffer, into pinned memory, and :meth:`get` waits only for that copy —
    not for work enqueued later. On the CPU the buffer is host memory
    already."""

    def __init__(self, tensor: torch.Tensor):
        self._event = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(
                tensor.shape, dtype=tensor.dtype, pin_memory=True
            )
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class ContinuousBatcher:
    """Iteration-level scheduler over a KV-cache decode model.

    ``model`` must be built with ``decode_max_length`` ≥ the longest
    ``len(prompt) + max_new_tokens - 1`` it will serve, and carries its own
    weights and device. ``submit()`` queues a request (admitted into the
    first free slot at the next step/chunk boundary); ``step()`` advances
    every active slot by one token and returns ``{rid: token}`` for tokens
    EMITTED this step (generation phase only); ``step_chunk()`` advances by
    ``chunk_size`` tokens in one dispatch and returns ``{rid: [tokens]}``.
    ``outputs[rid]`` accumulates; ``drain()`` runs (double-buffered) chunks
    until every submitted request finishes.

    ``chunk_size``: decode steps fused per dispatch (default 8). ``None``
    selects the per-token stepping path. ``overlap`` (fused mode) lets
    ``drain()`` keep one chunk in flight while the previous chunk's tokens
    are fetched. ``temperature > 0`` needs an explicit ``generator``.

    Paged KV: ``page_size`` switches to page pools + page tables.
    ``num_pages`` sizes the pool (default: every slot at full
    ``decode_max_length`` plus the reserved garbage page — no savings until
    it is shrunk). ``prefix_cache``: None (default) enables it when every
    cache leaf is pageable, True forces it (raising if unsound), False
    disables it. ``kv_quant="int8"`` (paged mode only) stores int8 pools
    with f32 per-slot scales.
    """

    def __init__(
        self,
        model,
        *,
        batch_size: int,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        chunk_size: Optional[int] = 8,
        overlap: bool = True,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        kv_quant: Optional[str] = None,
    ):
        refuse_expert_parallel(model, "ContinuousBatcher")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature > 0 needs a torch.Generator")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self._model = model
        self._dev = model.device
        self._b = batch_size
        self._eos = eos_id
        self._temp = temperature
        self._gen = generator
        self._k = chunk_size
        self._overlap = overlap and chunk_size is not None
        self._dml = int(getattr(model, "decode_max_length", 0))
        if self._dml <= 0:
            raise ValueError("model must be built with decode_max_length > 0")

        # paged KV mode: page pools + per-row page tables; allocation,
        # refcounting and prefix caching are host work at the chunk
        # boundaries (loop/kv_paging.py)
        self._paged = page_size is not None
        self._kv = None
        if self._paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self._page_size = int(page_size)
            self._pages_per_row = -(-self._dml // self._page_size)
            self._num_pages = (
                int(num_pages) if num_pages is not None
                # default: every slot can hold a full-length request (+ the
                # reserved garbage page); shrink it to overcommit memory
                else batch_size * self._pages_per_row + 1
            )
        elif num_pages is not None or prefix_cache is not None:
            raise ValueError(
                "num_pages/prefix_cache need paged mode (set page_size)"
            )
        if kv_quant is not None and not self._paged:
            raise ValueError("kv_quant needs paged mode (set page_size)")
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}"
            )
        self._kv_quant = kv_quant

        self._slots = [_Slot() for _ in range(batch_size)]
        self._queue: collections.deque[_Request] = collections.deque()
        self._next_rid = 0
        self._tokens = np.zeros((batch_size,), np.int32)  # per-token inputs
        self.outputs: dict[int, list[int]] = {}
        self.done: set[int] = set()
        self.stats = ServeStats()
        self._cache = self._init_cache()
        # KV residency accounting (hbm_bytes_per_request): peak concurrent
        # running requests over the measurement window
        self._peak_running = 0
        if self._paged:
            unpageable = list(self._cache.unpageable_leaves)
            if prefix_cache and unpageable:
                raise ValueError(
                    "prefix_cache=True is unsound for this model: cache "
                    f"leaves {unpageable} hold per-row recurrent state that "
                    "summarizes the whole prefix and cannot be restored "
                    "from KV pages"
                )
            self._kv = PagedKVAllocator(
                num_pages=self._num_pages,
                page_size=self._page_size,
                rows=batch_size,
                max_pages_per_row=self._pages_per_row,
                enable_prefix_cache=(
                    prefix_cache if prefix_cache is not None
                    else not unpageable
                ),
            )
            self._kv_table_dirty = False  # the zeroed table matches the mirror

        # fused-mode device carries, updated by every chunk
        dev = self._dev
        self._tok_d = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        self._pos_d = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        self._live_d = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
        self._rem_d = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        # dispatched-but-unharvested fused chunks, FIFO
        self._pending: collections.deque[tuple] = collections.deque()

    def _init_cache(self):
        """The batcher's decode cache: per-row ``[B]`` write indices in
        place of the scalar one (the decode modules accept either rank);
        in paged mode the page pools, scale pools and page table. Records
        the dense layout's KV bytes (the contiguous mode's residency and the
        paged mode's savings denominator) and the bytes of one page."""
        if not self._paged:
            cache = self._model.init_cache(self._b, per_row=True)
            self._kv_bytes_static = sum(
                x.nbytes for x in (*cache.keys, *cache.values))
            return cache
        cache = self._model.init_cache(
            self._b, page_size=self._page_size, num_pages=self._num_pages,
            kv_quant=self._kv_quant,
        )
        self._kv_bytes_static = cache.dense_bytes
        self._page_bytes = cache.page_bytes
        return cache

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host plan → device. From pinned memory and asynchronous on a CUDA
        device, so the host never waits for the chunk still in flight."""
        t = torch.from_numpy(array)
        if self._dev.type == "cuda":
            return t.pin_memory().to(self._dev, non_blocking=True)
        return t.to(self._dev)

    # ------------------------------------------------------------------
    # device steps

    def _model_step(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One single-token decode call over every slot → float32 logits
        ``[B, V]``. Writes the cache in place and advances every row's
        write index by one."""
        logits = self._model.logits_last(
            tok[:, None], pos[:, None], mask=None, cache=self._cache
        )
        return logits[:, -1].float()

    def _sample(self, row_logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(
            row_logits, temperature=self._temp, generator=self._gen
        )

    @torch.no_grad()
    def _run_step(self, tok, pos, live):
        """The per-token step: decode, sample, pin idle rows' indices."""
        nxt = self._sample(self._model_step(tok, pos))
        # idle rows ride through the static-shape step; pin their write
        # index so an arbitrarily long idle stretch can't run past capacity
        # or defeat the flash block skip
        self._pin(live)
        return nxt

    def _pin(self, live: torch.Tensor) -> None:
        """Pin dead/idle rows' write indices to 0 and, paged, their page
        tables to the garbage page (both in place, on the device)."""
        self._cache.pin_index(live)
        if self._paged:
            self._cache.pin_page_table(live)

    @torch.no_grad()
    def _run_fused(self, k: int, plan: torch.Tensor, admit_rows: list[int]):
        """One fused K-step chunk. ``plan`` is the uploaded ``[K+5, B]``
        int32 host plan: rows ``0..K-1`` the forced prompt tokens per step,
        then ``n_forced``, ``emit_from``, the admit mask, the admit budgets
        and the admit positions (paged: the first token past a prefix-cache
        hit; else 0). Returns the ``[B, K]`` device-side emission buffer."""
        forced_t = plan[:k]
        n_forced, emit_from = plan[k], plan[k + 1]
        tok, pos, live, rem = (
            self._tok_d, self._pos_d, self._live_d, self._rem_d
        )
        if admit_rows:
            # boundary work, enqueued with the chunk: reset admitted rows'
            # cache (paged: only their write index — the pools are shared)
            # and their carries
            admit_mask = plan[k + 2].bool()
            admit_pos = plan[k + 4]
            if self._paged:
                self._cache.reset_rows(admit_mask, admit_pos)
            else:
                self._cache.zero_rows(admit_rows)
            pos = torch.where(admit_mask, admit_pos, pos)
            live = live | admit_mask
            rem = torch.where(admit_mask, plan[k + 3], rem)
        eos = self._eos
        zero = torch.zeros_like(tok)
        outs = []
        for j in range(k):
            # input: host-forced prompt token while any remain for this
            # row, else the previous step's sampled token
            inp = torch.where((j < n_forced) & live, forced_t[j], tok)
            inp = torch.where(live, inp, zero)
            pos_in = torch.where(live, pos, zero)
            nxt = self._sample(self._model_step(inp, pos_in))
            emit = live & (j >= emit_from)
            outs.append(torch.where(emit, nxt, torch.full_like(nxt, -1)))
            # per-row stop masks, applied on the device: the finishing
            # emission itself goes out, then the row is dead for the rest
            # of the chunk (harvested at the boundary)
            rem = rem - emit.to(torch.int32)
            died = emit & (rem <= 0)
            if eos is not None:
                died = died | (emit & (nxt == eos))
            live = live & ~died
            tok = torch.where(live, nxt, tok)
            pos = torch.where(live, pos + 1, pos)
            self._pin(live)
        self._tok_d, self._pos_d, self._live_d, self._rem_d = (
            tok, pos, live, rem
        )
        # the [B, K] emission buffer the host fetches in ONE readback
        return torch.stack(outs, dim=1)

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], *, max_new_tokens: int) -> int:
        """Queue a request; returns its request id. Admission happens at
        the next step/chunk boundary with a free slot."""
        prompt = [int(x) for x in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        need = len(prompt) + max_new_tokens - 1
        if need > self._dml:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens}"
                f" - 1 = {need} exceeds decode_max_length={self._dml}"
            )
        if self._paged and not self._kv.fits_ever(need):
            raise ValueError(
                f"request needs {self._kv.pages_needed(need)} pages but "
                f"the pool holds {self._num_pages - 1} allocatable "
                f"(num_pages={self._num_pages}, page_size="
                f"{self._page_size}); it could never be admitted"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, max_new_tokens))
        self.outputs[rid] = []
        return rid

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s.rid >= 0) + len(self._queue)

    def _busy(self) -> bool:
        return any(s.rid >= 0 for s in self._slots)

    def export_kv_pages(self, *args, **kwargs):
        """Cross-replica KV page shipment — not ported yet (ROADMAP A10)."""
        raise NotImplementedError(
            "export_kv_pages (KV page shipment) is not ported yet")

    def import_kv_pages(self, *args, **kwargs):
        """Cross-replica KV page shipment — not ported yet (ROADMAP A10)."""
        raise NotImplementedError(
            "import_kv_pages (KV page shipment) is not ported yet")

    # ------------------------------------------------------------------
    # paged KV bookkeeping (loop/kv_paging.py): all host work, all at the
    # existing chunk boundaries — no dispatch and no readback is added

    def _try_alloc(self, row: int, req: _Request):
        """Map the queue head onto pages (prefix-cache walk + free-list
        allocation); None leaves it queued — admission is bounded by free
        pages, not rows."""
        alloc = self._kv.admit(row, req.rid, req.prompt, req.total_tokens)
        if alloc is not None:
            self._kv_table_dirty = True
        return alloc

    def _push_page_table(self) -> None:
        """Sync the device page table from the host mirror: one asynchronous
        upload from pinned memory, ordered before the next dispatch on the
        stream. Only called at clean boundaries (no chunk in flight), so a
        zeroed row reroutes a retired row's writes to the garbage page
        before its next step."""
        if not self._kv_table_dirty:
            return
        self._kv_table_dirty = False
        table = torch.from_numpy(self._kv.table.copy())
        if self._dev.type == "cuda":
            table = table.pin_memory()
        self._cache.set_page_table(table)

    def _release_row_pages(self, row: int, *, device_dead: bool) -> None:
        """Drop a retired row's page references. ``device_dead`` rows
        (finished on the device: their writes are already pinned to the
        garbage page) free at once; a row retired by the host with chunks
        in flight DEFERS — its device twin may still be writing into these
        pages, so they stay held until the zeroed table row has been pushed
        at a clean boundary (``flush_deferred``)."""
        if device_dead or not self._pending:
            self._kv.release(row)
        else:
            self._kv.defer_release(row)
        self._kv_table_dirty = True
        self._note_pages()

    def _note_pages(self) -> None:
        """Peak-concurrency accounting both modes share — host arithmetic."""
        running = sum(1 for s in self._slots if s.rid >= 0)
        self._peak_running = max(self._peak_running, running)

    def _admit_paged_boundary(self) -> None:
        """Clean-boundary page work before an admission pass: free deferred
        rows' pages (their zeroed table rows are pushed right after)."""
        if self._kv.flush_deferred():
            self._kv_table_dirty = True

    def hbm_bytes_per_request(self) -> float:
        """Peak resident KV bytes over peak concurrent running requests.
        Contiguous mode charges the full static allocation (every row's
        decode_max_length is resident whether used or not); paged mode
        charges the pages actually mapped."""
        if self._paged:
            resident = self._kv.peak_pages_in_use * self._page_bytes
        else:
            resident = self._kv_bytes_static
        return resident / max(1, self._peak_running)

    def prefix_hit_rate(self) -> float:
        """Admissions served (partly) from the prefix cache over all
        admissions; 0.0 when disabled or idle."""
        if self._kv is None:
            return 0.0
        total = self._kv.prefix_hits + self._kv.prefix_misses
        return self._kv.prefix_hits / total if total else 0.0

    # ------------------------------------------------------------------
    # per-token path (chunk_size=None): the exactness oracle for the fused
    # path and the latency-critical single-token mode

    def _admit_legacy(self):
        reset_rows = []
        admit_pos = np.zeros((self._b,), np.int32)
        if self._paged:
            self._admit_paged_boundary()
        for i, slot in enumerate(self._slots):
            if slot.rid >= 0 or not self._queue:
                continue
            req = self._queue[0]
            start_pos = 0
            if self._paged:
                alloc = self._try_alloc(i, req)
                if alloc is None:
                    break  # head-of-line waits for pages to free
                start_pos = alloc.start_pos
            self._queue.popleft()
            self._slots[i] = _Slot(
                rid=req.rid,
                pending=list(req.prompt[start_pos + 1:]),
                pos=start_pos,
                emitted=0,
                budget=req.max_new_tokens,
            )
            self._tokens[i] = req.prompt[start_pos]
            admit_pos[i] = start_pos
            reset_rows.append(i)
        if reset_rows:
            self._reset_rows(reset_rows, admit_pos)
            self.stats.host_dispatches += 1
        if self._paged:
            self._push_page_table()
        self._note_pages()

    def _reset_rows(self, rows: list[int], pos: np.ndarray) -> None:
        """Per-token path: reset the given rows' cache state — contiguous:
        zero their slices; paged: move their write index to ``pos``."""
        if self._paged:
            mask = np.zeros((self._b,), bool)
            mask[rows] = True
            self._cache.reset_rows(self._upload(mask), self._upload(pos))
        else:
            self._cache.zero_rows(rows)

    def _step_legacy(self) -> dict[int, int]:
        self._admit_legacy()
        if not self._busy():
            return {}
        pos = np.asarray([s.pos for s in self._slots], np.int32)
        live = np.asarray([s.rid >= 0 for s in self._slots], bool)
        nxt_d = self._run_step(
            self._upload(self._tokens.copy()), self._upload(pos),
            self._upload(live),
        )
        # the one [B] readback per token step
        nxt = _Readback(nxt_d).get()
        self.stats.host_dispatches += 1
        self.stats.readbacks += 1
        self.stats.device_steps += 1
        self.stats.slot_steps_total += self._b
        self.stats.slot_steps_busy += int(live.sum())

        emitted: dict[int, int] = {}
        evict_rows = []
        for i, slot in enumerate(self._slots):
            if slot.rid < 0:
                continue
            slot.pos += 1
            if self._paged and not slot.pending:
                # the whole prompt has been dispatched: this rid's prefix
                # cache entries become hit-eligible (idempotent)
                self._kv.mark_filled(slot.rid)
            if slot.pending:  # still consuming the prompt
                self._tokens[i] = slot.pending.pop(0)
                continue
            tok = int(nxt[i])  # sampled from the row's latest position
            emitted[slot.rid] = tok
            self.outputs[slot.rid].append(tok)
            slot.emitted += 1
            self.stats.emitted_tokens += 1
            finished = slot.emitted >= slot.budget or (
                self._eos is not None and tok == self._eos
            )
            if finished:
                self.done.add(slot.rid)
                self._slots[i] = _Slot()
                self._tokens[i] = 0
                evict_rows.append(i)
                if self._paged:
                    # per-token rows only step under a host live mask, so a
                    # cleared slot can never write again: free now
                    self._release_row_pages(i, device_dead=True)
            else:
                self._tokens[i] = tok
        if evict_rows:
            # reset at EVICTION, not just admission, so the freed row's
            # cache contents can't leak into a later diagnostic view
            self._reset_rows(evict_rows, np.zeros((self._b,), np.int32))
            self.stats.host_dispatches += 1
        return emitted

    # ------------------------------------------------------------------
    # fused path: one dispatch + one readback per K-step chunk

    def _dispatch_chunk(self, k: int, admit: bool) -> None:
        """Build the host plan for one fused chunk and dispatch it.

        ``admit`` must only be True when no chunk is in flight (the host's
        slot view is then exact); speculative follow-up chunks dispatch
        with ``admit=False`` and a plan that is deterministic given the
        previous dispatch (prompt feeding advances host-side, everything
        else is a device carry).
        """
        plan = np.zeros((k + 5, self._b), np.int32)
        forced, n_forced, emit_from = plan[:k], plan[k], plan[k + 1]
        admit_mask, admit_budget = plan[k + 2], plan[k + 3]
        admit_pos = plan[k + 4]
        emit_from[:] = k
        admit_rows = []
        if admit:
            if self._paged:
                # admit=True: no chunk in flight, so deferred pages free now;
                # the zeroed table rows are pushed below, before this dispatch
                self._admit_paged_boundary()
            for i, slot in enumerate(self._slots):
                if slot.rid >= 0 or not self._queue:
                    continue
                req = self._queue[0]
                start_pos = 0
                if self._paged:
                    alloc = self._try_alloc(i, req)
                    if alloc is None:
                        break  # head-of-line waits for pages
                    start_pos = alloc.start_pos
                self._queue.popleft()
                self._slots[i] = _Slot(
                    rid=req.rid,
                    # a prefix-cache hit skips the cached tokens: feeding
                    # resumes at the first un-cached one
                    feed=list(req.prompt[start_pos:]),
                    emitted=0,
                    budget=req.max_new_tokens,
                )
                admit_mask[i] = 1
                admit_budget[i] = req.max_new_tokens
                admit_pos[i] = start_pos
                admit_rows.append(i)
            if self._paged:
                self._push_page_table()
            self._note_pages()

        rids = []
        for i, slot in enumerate(self._slots):
            rids.append(slot.rid)
            if slot.rid < 0:
                continue
            m = len(slot.feed)
            nf = min(m, k)
            if nf:
                forced[:nf, i] = slot.feed[:nf]
            n_forced[i] = nf
            emit_from[i] = max(m - 1, 0)
            slot.feed = slot.feed[k:]

        toks = self._run_fused(k, self._upload(plan), admit_rows)
        if self._paged:
            for slot in self._slots:
                if slot.rid >= 0 and not slot.feed:
                    # the whole prompt is now DISPATCHED: this rid's prefix
                    # cache entries become hit-eligible — later admissions
                    # dispatch after it, so their reads see the writes
                    self._kv.mark_filled(slot.rid)
        self._pending.append(
            (_Readback(toks),
             _ChunkPlan(k=k, rids=rids, emit_from=emit_from.tolist()))
        )
        self.stats.host_dispatches += 1
        self.stats.chunks += 1
        self.stats.device_steps += k

    def _harvest_one(self) -> dict[int, list[int]]:
        """Fetch the oldest in-flight chunk (ONE readback) and replay the
        device's emission/stop logic on it to commit host state."""
        readback, plan = self._pending.popleft()
        toks = readback.get()  # the single [B, K] readback per chunk
        self.stats.readbacks += 1
        self.stats.slot_steps_total += self._b * plan.k
        emitted: dict[int, list[int]] = {}
        for i, rid in enumerate(plan.rids):
            if rid < 0 or rid in self.done:
                # idle at dispatch, or finished in an earlier chunk that
                # was harvested after this one was (speculatively)
                # dispatched — the device masked it dead already
                continue
            slot = self._slots[i]
            # exact occupancy, replayed like the device's stop masks: a
            # row is busy through the step it dies on, idle after
            busy_steps = plan.k
            for j in range(min(plan.emit_from[i], plan.k), plan.k):
                tok = int(toks[i, j])
                emitted.setdefault(rid, []).append(tok)
                self.outputs[rid].append(tok)
                slot.emitted += 1
                self.stats.emitted_tokens += 1
                if slot.emitted >= slot.budget or (
                    self._eos is not None and tok == self._eos
                ):
                    self.done.add(rid)
                    self._slots[i] = _Slot()
                    busy_steps = j + 1
                    if self._paged:
                        # the device row died at this same step (its later
                        # writes go to the garbage page), so its pages free
                        # now; reuse waits for the next admit boundary,
                        # which pushes the zeroed table row first
                        self._release_row_pages(i, device_dead=True)
                    break
            self.stats.slot_steps_busy += busy_steps
        return emitted

    def _sync(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        while self._pending:
            for rid, toks in self._harvest_one().items():
                out.setdefault(rid, []).extend(toks)
        return out

    def _may_outlive_pending(self) -> bool:
        """Could any busy row still be live after the in-flight chunks?

        With no EOS, stopping is budget-only and fully host-predictable, so
        a speculative chunk that could only serve dead rows is never
        dispatched. With an EOS id any emission may stop a row — the host
        can't know until readback, so speculation proceeds (worst case: one
        wasted chunk at the tail of a drain).
        """
        if self._eos is not None:
            return True
        proj = {
            i: s.emitted for i, s in enumerate(self._slots) if s.rid >= 0
        }
        for _readback, plan in self._pending:
            for i in proj:
                if plan.rids[i] == self._slots[i].rid:
                    proj[i] += max(0, plan.k - plan.emit_from[i])
        return any(proj[i] < self._slots[i].budget for i in proj)

    def step_chunk(self) -> dict[int, list[int]]:
        """Admit waiting requests, advance every slot ``chunk_size`` tokens
        in ONE dispatch; returns ``{rid: [tokens]}`` emitted (generation
        phase) during the chunk. Fused mode only."""
        if self._k is None:
            raise RuntimeError(
                "step_chunk() needs a fused batcher (chunk_size not None)"
            )
        self._sync()
        if not self._busy() and not self._queue:
            return {}
        self._dispatch_chunk(self._k, admit=True)
        return self._sync()

    def step(self) -> dict[int, int]:
        """Admit waiting requests, advance every slot one token; returns
        ``{rid: token}`` for tokens emitted (generation phase) this step.

        In fused mode this runs a K=1 chunk (same one-dispatch boundary
        semantics); with ``chunk_size=None`` it is the per-token path.
        """
        if self._k is None:
            return self._step_legacy()
        self._sync()
        if not self._busy() and not self._queue:
            return {}
        self._dispatch_chunk(1, admit=True)
        return {
            rid: toks[0] for rid, toks in self._sync().items() if toks
        }

    def drain(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Run until every submitted request has finished.

        Fused mode pipelines chunks double-buffered: while no admissions
        are waiting, the next chunk is dispatched BEFORE the previous
        chunk's tokens are fetched, overlapping the host readback and plan
        building with device compute. Admission needs an exact slot view,
        so a non-empty queue forces a synchronous boundary.
        """
        if self._k is None:
            steps = 0
            while self.active:
                self._step_legacy()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError("drain exceeded max_steps")
            return self.outputs

        steps = 0
        while self.active or self._pending:
            # admissions are waiting: sync so freed slots refill promptly
            # (and so the admit plan sees exact state)
            while self._pending and self._queue:
                self._harvest_one()
            if self._queue or (self._busy() and self._may_outlive_pending()):
                self._dispatch_chunk(self._k, admit=not self._pending)
                steps += self._k
                if steps > max_steps:
                    self._sync()
                    raise RuntimeError("drain exceeded max_steps")
                # keep at most one chunk in flight beyond the newest: the
                # harvest of chunk N overlaps chunk N+1's device compute
                while len(self._pending) > (1 if self._overlap else 0):
                    self._harvest_one()
            elif self._pending:
                self._harvest_one()
        return self.outputs
