"""Background batch prefetch: overlap host input work with device steps
(counterpart of ``d9d_tpu/loop/components/prefetch.py``).

A producer thread runs the host input pipeline — the raw fetch from the
loader, the task's ``prepare_batch`` and the cut into this rank's rows and
sequence chunk, into pinned host tensors on a card — ``depth`` batches
ahead of the consuming train loop, so step N's device work overlaps step
N+1's input processing. The host-to-device copy runs on the consumer
thread (``finish_fn``): a copy issued from the producer would need a
stream and events of its own and gains nothing here. No collective runs in
the producer: a collective issued from a second thread interleaves
differently on each rank against the main thread's step collectives.

Exact resume stays exact: the producer snapshots the loader's *position*
right after each fetch (the loader advances before yielding, so the
snapshot IS the resume point after consuming that batch), and the
consumer records the snapshot of every batch it hands out. Checkpoints
then serialize the loader state *as of the consumed batch* through
``StatefulDataLoader.state_dict_at`` — never the producer's run-ahead
position.

The JAX package counts producer errors into its telemetry registry
(``io/prefetch_errors``), which the port does not have (ROADMAP A11): the
count is the prefetcher's ``errors`` attribute.
"""

import queue
import threading
from collections.abc import Callable, Iterator
from typing import Any

__all__ = ["BatchPrefetcher"]

_DONE = object()


class BatchPrefetcher:
    """Iterator of staged batches produced ``depth`` ahead on a thread.

    ``stage_fn`` runs in the producer thread; ``finish_fn`` (if given) runs
    on the CONSUMER thread at ``__next__``; ``position_fn`` (optional)
    snapshots the underlying loader position after each raw fetch —
    :attr:`consumed_position` then tracks the resume point of the last
    batch handed to the consumer.
    """

    def __init__(
        self,
        data_iter: Iterator[Any],
        stage_fn: Callable[[Any], Any],
        *,
        depth: int = 2,
        position_fn: Callable[[], Any] | None = None,
        finish_fn: Callable[[Any], Any] | None = None,
    ):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._iter = data_iter
        self._stage_fn = stage_fn
        self._finish_fn = finish_fn
        self._position_fn = position_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.consumed_position: Any | None = None
        self.errors = 0
        self._thread = threading.Thread(
            target=self._produce, name="d9d-batch-prefetch", daemon=True
        )
        self._thread.start()

    # -- producer ------------------------------------------------------

    def _put(self, item) -> bool:
        """Bounded put that aborts promptly when the consumer closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    raw = next(self._iter)
                except StopIteration:
                    self._put(_DONE)
                    return
                pos = self._position_fn() if self._position_fn else None
                staged = self._stage_fn(raw)
                if not self._put(("batch", staged, pos)):
                    return
        except BaseException as e:  # noqa: BLE001 — reraised in consumer
            self.errors += 1
            self._put(("error", e, None))

    # -- consumer ------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        # bounded waits + liveness checks: a producer thread that dies
        # without delivering its sentinel must surface as an immediate,
        # explanatory error — not an unbounded q.get() hang
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # the producer may have enqueued its final item and
                    # exited between our timeout and this liveness check —
                    # drain once more before declaring a silent death
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        pass
                    raise RuntimeError(
                        "prefetch producer thread died without delivering "
                        "a batch, an error, or end-of-data (last consumed "
                        f"position: {self.consumed_position})"
                    ) from None
        if item is _DONE:
            raise StopIteration
        kind, payload, pos = item
        if kind == "error":
            # the producer's exception travels intact (DataFetchError
            # carries the failing epoch/batch position in its message)
            raise payload
        if self._finish_fn is not None:
            payload = self._finish_fn(payload)
        # only after the batch is fully materialized for the consumer — a
        # finish_fn failure must not mark the batch consumed (exact resume
        # would skip it)
        self.consumed_position = pos
        return payload

    def close(self) -> None:
        """Stop the producer and release its queue slot."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
