"""Stateful data loading (counterpart of
``d9d_tpu/loop/components/data_loader.py``).

A loader whose position (epoch, batch index, the dataset's own state) is
part of the job checkpoint, namespaced per feeder so resume is exact. The
feeder unit is the process, one a rank: state keys are ``process_{rank}``,
gathered from every rank with ``core/collectives.py``
``host_allgather_object``. In the port every rank reads the same global
batch (``loop/components/batch_staging.py`` keeps its rows), so every
rank's position is the same; each still restores its own entry.

The JAX package counts retries into its telemetry registry
(``io/data_retries``), which the port does not have (ROADMAP A11): the
count is the loader's ``retries`` attribute.
"""

import time
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch.distributed as dist

from d9d_tpu_torch.core.collectives import host_allgather_object


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure nested dicts, lists and
    tuples (the JAX package's ``jax.tree.map`` for collation)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def default_collate(items: Sequence[Any]) -> Any:
    """Stack a list of same-structure trees of arrays along a new leading
    batch dim (numpy, on the host)."""
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class DataFetchError(RuntimeError):
    """A batch fetch failed after exhausting its retry budget.

    Carries the failing position so the consumer-side re-raise (possibly
    on the other end of a prefetch queue) names exactly which batch died
    instead of surfacing a bare timeout.
    """

    def __init__(self, message: str, *, epoch: int, batch_index: int):
        super().__init__(message)
        self.epoch = epoch
        self.batch_index = batch_index


class StatefulDataLoader:
    """Map-style dataset → batch iterator with exact-resume state.

    Shuffling draws a fresh permutation per epoch from ``seed + epoch`` so
    resume mid-epoch reproduces the same order without storing the
    permutation itself.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        collate_fn: Callable[[Sequence[Any]], Any] = default_collate,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_epochs: int | None = 1,
        retry_attempts: int = 0,
        retry_backoff_s: float = 0.05,
        retry_max_backoff_s: float = 5.0,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if retry_attempts < 0:
            raise ValueError("retry_attempts must be >= 0")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_epochs = num_epochs
        # each batch fetch retries up to retry_attempts times with capped
        # exponential backoff before failing the run with a DataFetchError
        # naming the epoch/batch position
        self.retry_attempts = retry_attempts
        self.retry_backoff_s = retry_backoff_s
        self.retry_max_backoff_s = retry_max_backoff_s
        self.retries = 0
        self._epoch = 0
        self._batch_index = 0

    def _fetch_batch(self, idxs: np.ndarray, b: int) -> Any:
        """One batch fetch + collate with capped-exponential retry.
        Retries restart the whole batch (a flaky source may fail partway
        through the item list) and count into ``retries``."""
        attempt = 0
        while True:
            try:
                items = [self.dataset[int(i)] for i in idxs]
                return self.collate_fn(items)
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt >= self.retry_attempts:
                    raise DataFetchError(
                        f"batch fetch failed at epoch {self._epoch} batch "
                        f"{b} after {attempt + 1} attempt(s): "
                        f"{type(e).__name__}: {e}",
                        epoch=self._epoch,
                        batch_index=b,
                    ) from e
                delay = min(self.retry_backoff_s * (2.0 ** attempt),
                            self.retry_max_backoff_s)
                self.retries += 1
                attempt += 1
                time.sleep(delay)

    def __len__(self) -> int:
        n = len(self.dataset)
        per_epoch = (
            n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        )
        return per_epoch if self.num_epochs is None else per_epoch * self.num_epochs

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + epoch).permutation(n)

    def __iter__(self):
        while self.num_epochs is None or self._epoch < self.num_epochs:
            order = self._epoch_order(self._epoch)
            n_batches = len(order) // self.batch_size
            if not self.drop_last and len(order) % self.batch_size:
                n_batches += 1
            while self._batch_index < n_batches:
                b = self._batch_index
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                batch = self._fetch_batch(idxs, b)
                # advance BEFORE yielding: a checkpoint taken after the step
                # that consumed batch b must record position b+1
                self._batch_index = b + 1
                yield batch
            self._epoch += 1
            self._batch_index = 0

    # -- state ---------------------------------------------------------

    def position(self) -> dict[str, Any]:
        """Local position snapshot (no collectives — safe to call from a
        prefetch producer thread after each fetch). Because ``__iter__``
        advances ``batch_index`` before yielding, the snapshot taken after
        fetching batch ``b`` is exactly the resume point for a job that
        consumed ``b``."""
        my = {"epoch": self._epoch, "batch_index": self._batch_index}
        if hasattr(self.dataset, "state_dict"):
            my["dataset"] = self.dataset.state_dict()
        return my

    def _merged_state(self, my: dict[str, Any]) -> dict[str, Any]:
        # every feeder's position must land in the (rank-0-written) job
        # meta: a collective, called by every rank on its main thread
        return {f"process_{i}": s
                for i, s in enumerate(host_allgather_object(my))}

    def state_dict(self) -> dict[str, Any]:
        return self._merged_state(self.position())

    def state_dict_at(self, position: dict[str, Any]) -> dict[str, Any]:
        """State dict for an explicit :meth:`position` snapshot — how a
        prefetching trainer checkpoints the *consumed* position while the
        producer thread runs ahead (collective; call from the main thread
        on every rank together)."""
        return self._merged_state(position)

    def load_state_dict(self, state: dict[str, Any]) -> None:
        key = f"process_{_process_index()}"
        if key not in state:
            raise KeyError(
                f"loader state has no entry for {key} (keys: {list(state)})"
            )
        my = state[key]
        self._epoch = my["epoch"]
        self._batch_index = my["batch_index"]
        if "dataset" in my and hasattr(self.dataset, "load_state_dict"):
            self.dataset.load_state_dict(my["dataset"])
