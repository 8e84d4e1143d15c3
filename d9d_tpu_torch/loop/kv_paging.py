"""Host-side bookkeeping for the paged KV cache + prefix cache (the port's
copy of ``d9d_tpu/loop/kv_paging.py``, which the port may not import; the
two are kept identical below this docstring).

The device side of paging is deliberately dumb: a pool of fixed-size
pages per cache leaf plus a static-shape ``[B, max_pages]`` int32 page
table that the decode step indexes through (``nn/attention.py`` paged
write, ``ops/attention/decode.py`` / ``csrc/flash_decode.cu`` paged
read). Everything with policy in it — allocation, free lists, reference
counting, content-hashed prefix reuse, LRU eviction — lives HERE, on the
host, and only ever runs at the serving loop's existing chunk boundaries
(admit/retire), so the one-dispatch / one-readback-per-K-tokens contract
is untouched.

Page identity contract: page 0 is the reserved GARBAGE page — never
allocated, never freed. Idle/dead device rows have their page-table
rows pinned to 0 on the device (``loop/serve.py``, the cache's
``pin_page_table``), so a row that dies mid-chunk scribbles into the
garbage page instead of a page the allocator may have handed to someone
else (or, worse, a shared prefix page).

Prefix cache contract: an entry maps a CONTENT HASH CHAIN over
page-size token blocks of a prompt to the page run holding their KV.
KV at slot ``s`` depends only on tokens ``0..s`` (causal), so a page
fully covered by prompt tokens is reusable by any prompt sharing that
exact token prefix. Entries hold one reference on their page; a hit
adds a per-row reference (copy-on-write: readers share, every writer
appends into its OWN pages past the shared run). An entry only becomes
hit-eligible (``ready``) once its filling row's prompt feed has been
fully DISPATCHED — device execution is in dispatch order, so a later
request's reads are guaranteed to see the writes. Eviction is LRU over
ready leaf entries (deepest-suffix first), and only at admission
boundaries when the free list runs short.
"""

import dataclasses
import hashlib
from typing import Optional

import numpy as np

__all__ = ["PageAllocation", "PagedKVAllocator"]


@dataclasses.dataclass
class PageAllocation:
    """One row's page run, handed back by :meth:`PagedKVAllocator.admit`.

    ``start_pos`` is the first token index the serving loop must still
    feed (``hit_tokens`` prompt tokens are served from shared pages and
    skipped); ``pages[:n_shared]`` are the prefix-cache pages (read
    only for this row), the rest are freshly allocated and owned.
    """

    row: int
    rid: int
    pages: list
    n_shared: int
    hit_tokens: int

    @property
    def start_pos(self) -> int:
        return self.hit_tokens


@dataclasses.dataclass
class _PrefixEntry:
    key: bytes
    parent: Optional[bytes]
    page: int
    depth: int              # page index within the prompt (0-based)
    last_use: int
    ready: bool
    owner_rid: Optional[int]
    children: set = dataclasses.field(default_factory=set)


class PagedKVAllocator:
    """Free-list page allocator + refcounts + content-hashed prefix
    cache + the host mirror of the device page table.

    Deterministic by construction (explicit free-list order, a logical
    clock for LRU) so chaos/parity tests can assert exact behavior.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int,
        rows: int,
        max_pages_per_row: int,
        enable_prefix_cache: bool = True,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved garbage "
                f"page), got {num_pages}"
            )
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_row = int(max_pages_per_row)
        self.prefix_cache_enabled = bool(enable_prefix_cache)
        # pop() yields ascending ids on a fresh allocator; freed pages
        # return LIFO — both deterministic
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros(num_pages, np.int64)
        # host mirror of the device table (page 0 everywhere = garbage)
        self.table = np.zeros((rows, max_pages_per_row), np.int32)
        self._row_alloc: dict[int, PageAllocation] = {}
        # rows whose requests retired while chunks were still in flight:
        # their pages stay held (the device row may still be live and
        # writing) until flush_deferred() at a clean boundary
        self._deferred: dict[int, PageAllocation] = {}
        # prefix cache
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._filling: dict[int, list[bytes]] = {}
        # rid → chain keys, memoized across admission ATTEMPTS: a
        # head-of-line request blocked on pages is retried every chunk
        # boundary, and its hash chain depends only on its prompt —
        # O(prompt) hashing must not repeat per boundary. Dropped on
        # successful admit / abort / forget.
        self._key_memo: dict[int, list[bytes]] = {}
        self._clock = 0
        # counters (the batcher mirrors these into telemetry)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.peak_pages_in_use = 0

    # -- accounting ----------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_free_after_flush(self) -> int:
        """Free pages counting those :meth:`flush_deferred` will free at
        the next clean boundary (refcount simulation: a deferred page
        frees iff deferred references are ALL that hold it — pages a
        prefix entry or live row still shares correctly stay). The
        admission-capacity view for callers deciding between boundaries."""
        pend: dict[int, int] = {}
        for alloc in self._deferred.values():
            for p in alloc.pages:
                pend[p] = pend.get(p, 0) + 1
        extra = sum(1 for p, n in pend.items() if self._refs[p] == n)
        return len(self._free) + extra

    def pages_needed(self, total_tokens: int) -> int:
        return -(-int(total_tokens) // self.page_size)

    def fits_ever(self, total_tokens: int) -> bool:
        """Could a request of this token footprint EVER be admitted
        (every page free, nothing cached)? Submit-time validation."""
        return self.pages_needed(total_tokens) <= self.num_pages - 1

    # -- page primitives -----------------------------------------------

    def _alloc_page(self) -> int:
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _incref(self, page: int) -> None:
        self._refs[page] += 1

    def _decref(self, page: int) -> None:
        if page == 0:
            raise AssertionError("decref of the reserved garbage page")
        self._refs[page] -= 1
        if self._refs[page] < 0:
            raise AssertionError(f"negative refcount on page {page}")
        if self._refs[page] == 0:
            self._free.append(page)

    # -- prefix hashing ------------------------------------------------

    def _chain_keys(self, prompt, n_blocks: int) -> list[bytes]:
        """Content-hash chain over the first ``n_blocks`` page-size
        token blocks: ``key_i = H(key_{i-1} || tokens[i·ps:(i+1)·ps])``
        — a hit on block i implies the whole prefix matched."""
        ps = self.page_size
        keys = []
        digest = b""
        for i in range(n_blocks):
            block = np.asarray(prompt[i * ps:(i + 1) * ps], np.int64)
            digest = hashlib.sha1(digest + block.tobytes()).digest()
            keys.append(digest)
        return keys

    # -- admission -----------------------------------------------------

    def admit(
        self, row: int, rid: int, prompt, total_tokens: int
    ) -> Optional[PageAllocation]:
        """Map a request onto pages: walk the prefix cache over the
        prompt's full page-size blocks (capped so at least one prompt
        token is still fed — the request needs the last prompt
        position's logits), allocate the rest, register the request's
        own full-prompt pages as filling prefix entries. Returns None
        (leaving the caller's queue untouched) when even LRU eviction
        cannot free enough pages THIS boundary."""
        if row in self._row_alloc:
            raise AssertionError(f"row {row} already has an allocation")
        ps = self.page_size
        need = self.pages_needed(total_tokens)
        if need > self.max_pages_per_row:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_row="
                f"{self.max_pages_per_row}"
            )
        full_blocks = len(prompt) // ps
        keys: list[bytes] = []
        if self.prefix_cache_enabled:
            keys = self._key_memo.get(rid, [])
            if len(keys) != full_blocks:
                keys = self._chain_keys(prompt, full_blocks)
                self._key_memo[rid] = keys
        # cap: at least one prompt token must remain to be fed
        max_hit_blocks = (len(prompt) - 1) // ps
        hits = 0
        for i in range(min(max_hit_blocks, len(keys))):
            e = self._entries.get(keys[i])
            if e is None or not e.ready:
                break
            hits += 1
        # claim the hit run BEFORE any eviction: with the extra
        # reference the hit entries can never be this same admission's
        # eviction victims (rolled back if admission still fails)
        self._clock += 1
        pages = []
        for i in range(hits):
            e = self._entries[keys[i]]
            e.last_use = self._clock
            self._incref(e.page)
            pages.append(e.page)
        own_needed = need - hits
        if own_needed > len(self._free):
            self._evict_lru(own_needed - len(self._free))
        if own_needed > len(self._free):
            for p in pages:
                self._decref(p)
            return None
        pages.extend(self._alloc_page() for _ in range(own_needed))
        # register this prompt's own full blocks as filling entries
        if self.prefix_cache_enabled:
            for i in range(hits, full_blocks):
                if keys[i] in self._entries:
                    continue  # cached already (capped hit / race): keep it
                parent = keys[i - 1] if i > 0 else None
                self._entries[keys[i]] = _PrefixEntry(
                    key=keys[i], parent=parent, page=pages[i], depth=i,
                    last_use=self._clock, ready=False, owner_rid=rid,
                )
                self._incref(pages[i])
                if parent is not None and parent in self._entries:
                    self._entries[parent].children.add(keys[i])
                self._filling.setdefault(rid, []).append(keys[i])
        self.table[row, :] = 0
        self.table[row, : len(pages)] = pages
        self._key_memo.pop(rid, None)  # admitted: the memo served its job
        alloc = PageAllocation(
            row=row, rid=rid, pages=pages, n_shared=hits,
            hit_tokens=hits * ps,
        )
        self._row_alloc[row] = alloc
        if self.prefix_cache_enabled:
            if hits:
                self.prefix_hits += 1
                self.prefix_hit_tokens += hits * ps
            else:
                self.prefix_misses += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return alloc

    def mark_filled(self, rid: int) -> None:
        """The row's prompt feed has been fully dispatched: its filling
        prefix entries become hit-eligible (later dispatches execute
        after the writes)."""
        for key in self._filling.pop(rid, []):
            e = self._entries.get(key)
            if e is not None and e.owner_rid == rid:
                e.ready = True
                e.owner_rid = None

    def forget(self, rid: int) -> None:
        """Drop any admission-attempt memo for a request leaving the
        queue without admitting here (fleet ejection/migration)."""
        self._key_memo.pop(rid, None)

    def abort_filling(self, rid: int) -> None:
        """The filling row failed before its prompt was fully dispatched
        (deadline mid-prompt): its never-ready entries are dropped so a
        half-written page can never be hit."""
        self._key_memo.pop(rid, None)
        for key in self._filling.pop(rid, []):
            e = self._entries.get(key)
            if e is None or e.owner_rid != rid or e.ready:
                continue
            self._drop_entry(e)

    # -- release -------------------------------------------------------

    def release(self, row: int) -> None:
        """Free a row's page references NOW (the device row is dead —
        finished in-device, or the caller is at a clean boundary and
        will push a zeroed table row before the next dispatch)."""
        alloc = self._row_alloc.pop(row, None)
        if alloc is None:
            return
        for page in alloc.pages:
            self._decref(page)
        self.table[row, :] = 0

    def defer_release(self, row: int) -> None:
        """Retire a row whose device twin may still be LIVE (host-side
        deadline eviction with chunks in flight): zero the mirror row
        but keep the page references until :meth:`flush_deferred` at a
        clean boundary — the zombie keeps writing into its own
        still-held pages, never into someone else's."""
        alloc = self._row_alloc.pop(row, None)
        if alloc is None:
            return
        self._deferred[row] = alloc
        self.table[row, :] = 0

    def flush_deferred(self) -> bool:
        """At a clean boundary (no chunks in flight, the zeroed table
        about to be pushed): drop deferred rows' page references. The
        push reroutes any still-live zombie's writes to the garbage
        page, so the pages are safe to reuse. Returns True if anything
        was freed."""
        if not self._deferred:
            return False
        for alloc in self._deferred.values():
            for page in alloc.pages:
                self._decref(page)
        self._deferred.clear()
        return True

    # -- cross-replica shipment (disaggregated serving) ----------------

    def export_pages(self, rid: int) -> list:
        """Ordered page ids of ``rid``'s live row allocation,
        refcount-neutral (the caller only reads payloads; nothing moves
        or changes hands). Raises ``KeyError`` when the request holds
        no live row here — the caller falls back to re-prefill."""
        for alloc in self._row_alloc.values():
            if alloc.rid == rid:
                return list(alloc.pages)
        raise KeyError(f"rid {rid} has no live row allocation")

    def export_prefix(self, tokens) -> list:
        """Page ids of the leading READY prefix-cache run over
        ``tokens``' full page-size blocks (refcount-neutral). Chains are
        contiguous from block 0 by construction (leaf-first eviction),
        so the run is directly shippable block-by-block."""
        if not self.prefix_cache_enabled:
            return []
        full_blocks = len(tokens) // self.page_size
        pages = []
        for key in self._chain_keys(tokens, full_blocks):
            e = self._entries.get(key)
            if e is None or not e.ready:
                break
            pages.append(e.page)
        return pages

    def import_pages(self, tokens, n_blocks: int) -> Optional[list]:
        """Install the first ``n_blocks`` full page-size blocks of
        ``tokens`` as READY prefix entries backed by freshly allocated
        pages — the receiving half of a cross-replica shipment. Leading
        blocks already cached here are skipped (their payload is
        already on-device); a mid-chain entry another row is still
        FILLING stops the import early (never alias a page being
        written). Returns ``[(block_idx, dest_page), ...]`` for the
        blocks whose payloads the caller must copy into the device
        pool BEFORE the next dispatch that could hit them, or None
        when even LRU eviction cannot free enough pages — in which
        case the allocator is left untouched (no partial import)."""
        if not self.prefix_cache_enabled:
            return None
        ps = self.page_size
        n_blocks = min(int(n_blocks), len(tokens) // ps)
        if n_blocks <= 0:
            return []
        keys = self._chain_keys(tokens, n_blocks)
        self._clock += 1
        skip = 0
        for key in keys:
            e = self._entries.get(key)
            if e is None:
                break
            if not e.ready:
                return []  # filling mid-chain: nothing importable past it
            e.last_use = self._clock
            skip += 1
        need = n_blocks - skip
        if need > len(self._free):
            self._evict_lru(need - len(self._free))
        if need > len(self._free):
            return None
        placed = []
        for i in range(skip, n_blocks):
            page = self._alloc_page()
            parent = keys[i - 1] if i > 0 else None
            self._entries[keys[i]] = _PrefixEntry(
                key=keys[i], parent=parent, page=page, depth=i,
                last_use=self._clock, ready=True, owner_rid=None,
            )
            if parent is not None and parent in self._entries:
                self._entries[parent].children.add(keys[i])
            placed.append((i, page))
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return placed

    # -- invalidation --------------------------------------------------

    def invalidate_prefix_cache(self) -> int:
        """Drop EVERY prefix entry — cached KV is weights-dependent, so
        a live weight publish makes all of it stale (and a row mid-fill
        finishes its fill under the NEW weights, so its pending entries
        would be mixed-generation: those go too). Row page mappings are
        untouched: in-flight requests keep their pages and finish on
        the cache they built, exactly like contiguous rows complete on
        the weights their chunks were dispatched with. Returns the
        number of entries dropped."""
        n = len(self._entries)
        for e in list(self._entries.values()):
            self._drop_entry(e)
        self._filling.clear()
        self._key_memo.clear()
        return n

    # -- eviction ------------------------------------------------------

    def _drop_entry(self, e: _PrefixEntry) -> None:
        self._entries.pop(e.key, None)
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children.discard(e.key)
        self._decref(e.page)

    def _evict_lru(self, shortfall: int) -> int:
        """Evict ready LEAF entries (no cached children — deeper
        suffixes go first, so a chain never dangles) in LRU order until
        ``shortfall`` pages came FREE or nothing evictable remains.
        Only entries that are the SOLE holder of their page qualify:
        evicting one whose page live rows still share would free
        nothing now and destroy a warm cache line for no benefit.

        Heap-ordered, one pass: popping a non-leaf discards it, but an
        evicted child re-pushes its parent, so the parent is
        reconsidered exactly when it may have become evictable —
        O((entries + evictions)·log entries) per blocked admission,
        not O(entries × shortfall)."""
        import heapq

        freed = 0
        heap = [
            (e.last_use, -e.depth, e.key)
            for e in self._entries.values() if e.ready
        ]
        heapq.heapify(heap)
        while freed < shortfall and heap:
            _, _, key = heapq.heappop(heap)
            e = self._entries.get(key)
            if e is None or not e.ready:
                continue  # stale (already evicted) or still filling
            if e.children & self._entries.keys():
                continue  # not a leaf now; a child's eviction re-pushes
            if self._refs[e.page] != 1:
                continue  # shared with live rows: evicting frees nothing
            parent_key = e.parent
            before = len(self._free)
            self._drop_entry(e)
            freed += len(self._free) - before
            if parent_key is not None:
                pe = self._entries.get(parent_key)
                if pe is not None and pe.ready:
                    heapq.heappush(
                        heap, (pe.last_use, -pe.depth, pe.key)
                    )
        return freed

    # -- invariants (tests) --------------------------------------------

    def check_invariants(self) -> None:
        refs = np.zeros(self.num_pages, np.int64)
        for alloc in self._row_alloc.values():
            for p in alloc.pages:
                refs[p] += 1
        for alloc in self._deferred.values():
            for p in alloc.pages:
                refs[p] += 1
        for e in self._entries.values():
            refs[e.page] += 1
        assert refs[0] == 0, "garbage page must never be referenced"
        if not np.array_equal(refs, self._refs):
            raise AssertionError(
                f"refcount drift: recomputed {refs.tolist()} != "
                f"tracked {self._refs.tolist()}"
            )
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        for p in range(1, self.num_pages):
            held = self._refs[p] > 0
            assert held != (p in free), (
                f"page {p}: refs={self._refs[p]} free={p in free}"
            )
        for row, alloc in self._row_alloc.items():
            got = [int(x) for x in self.table[row] if x != 0]
            assert got == list(alloc.pages), (
                f"row {row} table/alloc mismatch: {got} != {alloc.pages}"
            )
