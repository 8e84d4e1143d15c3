"""Data-parallel dataset sharding and buffered length sorting (counterpart
of ``d9d_tpu/dataset/sharded.py``): ``ShardedDataset`` with sequential or
chunked indexing and pad-to-equal-length, ``BufferSortedDataset`` (the same
``random.Random(init_seed ^ 0x105E7)`` stream and the same base64-pickled
state, so a window sorts the same in both packages) and
``shard_dataset_data_parallel``.

The JAX package shards over its processes and reads their count and index
from the JAX runtime. The port reads nothing around it: the caller passes
the shard count and index, or the ``MeshContext`` whose processes to shard
over. The port's ``Trainer`` has every rank read the same global batch and
keep its rows of it (``loop/components/batch_staging.py``), so a dataset
it trains on is not sharded; this is for loops that feed each process its
own rows.
"""

import base64
import pickle
import random
from enum import Enum
from typing import Any, Protocol, Sized, TypeVar

_T_co = TypeVar("_T_co", covariant=True)


class Dataset(Protocol[_T_co]):
    def __len__(self) -> int:
        ...

    def __getitem__(self, index: int) -> _T_co:
        ...


class ShardIndexingMode(str, Enum):
    """sequential = round-robin across shards; chunked = contiguous blocks."""

    sequential = "sequential"
    chunked = "chunked"


class ShardedDataset:
    """A view onto one shard of an underlying dataset.

    With ``pad_to_equal_size_across_shards`` every shard reports the
    ceiling length and out-of-range reads clamp to the dataset's final
    element — data-parallel groups must never diverge in step count
    (reference rationale, sharded.py:44).
    """

    def __init__(
        self,
        dataset: Dataset[_T_co],
        total_shards: int,
        current_shard: int,
        indexing_mode: ShardIndexingMode = ShardIndexingMode.sequential,
        pad_to_equal_size_across_shards: bool = True,
    ):
        if not isinstance(dataset, Sized):
            raise ValueError(
                "sharding needs a sized dataset (no __len__ found)"
            )
        if not 0 <= current_shard < total_shards:
            raise ValueError(
                f"shard index {current_shard} invalid for a "
                f"{total_shards}-way split"
            )
        self._dataset = dataset
        self._total_shards = total_shards
        self._current_shard = current_shard
        self._indexing_mode = indexing_mode
        self._pad = pad_to_equal_size_across_shards

    # Layout: sequential interleaves shards with stride = total_shards;
    # chunked hands each shard one contiguous block of ceil(n/shards).

    @property
    def _padded_len(self) -> int:
        return -(-len(self._dataset) // self._total_shards)

    @property
    def _true_len(self) -> int:
        n, k, me = len(self._dataset), self._total_shards, self._current_shard
        if self._indexing_mode is ShardIndexingMode.sequential:
            return n // k + (1 if me < n % k else 0)
        start = self._padded_len * me
        return min(self._padded_len, max(0, n - start))

    def _global_index(self, index: int) -> int:
        if self._indexing_mode is ShardIndexingMode.sequential:
            return index * self._total_shards + self._current_shard
        return self._padded_len * self._current_shard + index

    def __len__(self) -> int:
        return self._padded_len if self._pad else self._true_len

    def __getitem__(self, index: int) -> _T_co:
        if not 0 <= index < len(self):
            raise IndexError(index)
        # padding reads (only possible with pad enabled) clamp to the end
        g = min(self._global_index(index), len(self._dataset) - 1)
        return self._dataset[g]

    def state_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "total_shards": self._total_shards,
            "current_shard": self._current_shard,
        }
        if hasattr(self._dataset, "state_dict"):
            out["dataset"] = self._dataset.state_dict()
        return out

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        if state_dict["total_shards"] != self._total_shards:
            raise ValueError(
                f"cannot restore a {state_dict['total_shards']}-way shard "
                f"state into a {self._total_shards}-way split"
            )
        self._current_shard = state_dict["current_shard"]
        if hasattr(self._dataset, "load_state_dict"):
            self._dataset.load_state_dict(state_dict["dataset"])


def shard_dataset_data_parallel(
    dataset: Dataset[_T_co],
    *,
    ctx=None,
    total_shards: int | None = None,
    current_shard: int | None = None,
    indexing_mode: ShardIndexingMode = ShardIndexingMode.sequential,
    pad_to_equal_size_across_shards: bool = True,
) -> ShardedDataset:
    """Shard over processes: those of ``ctx`` (a ``MeshContext``: its
    ``process_count`` / ``process_index``, one process a rank), or
    ``total_shards`` / ``current_shard`` as given."""
    if ctx is not None:
        if total_shards is not None or current_shard is not None:
            raise ValueError("pass ctx or total_shards/current_shard, not both")
        total_shards, current_shard = ctx.process_count, ctx.process_index
    if total_shards is None or current_shard is None:
        raise ValueError("shard_dataset_data_parallel needs ctx, or both "
                         "total_shards and current_shard")
    return ShardedDataset(
        dataset=dataset,
        total_shards=total_shards,
        current_shard=current_shard,
        indexing_mode=indexing_mode,
        pad_to_equal_size_across_shards=pad_to_equal_size_across_shards,
    )


class DatasetImplementingSortKeyProtocol(Protocol[_T_co]):
    """Dataset that can expose a sort key (e.g. length) without loading items."""

    def __len__(self) -> int:
        ...

    def sort_key(self, index: int) -> Any:
        ...

    def __getitem__(self, item: int) -> _T_co:
        ...


class BufferSortedDataset:
    """Buffered length-sorting with pack-level + intra-pack shuffling.

    Groups similar-length items (minimizing padding waste) while keeping
    stochasticity: materialize a window of ``buffer_size`` indices, order
    it by (sort_key, random jitter), cut into ``pack_size`` packs, then
    shuffle the packs and the items inside each pack.
    """

    def __init__(
        self,
        base_dataset: DatasetImplementingSortKeyProtocol[_T_co],
        buffer_size: int,
        pack_size: int,
        init_seed: int | None = None,
    ):
        self._base = base_dataset
        self._window = buffer_size
        self._pack = pack_size
        self._rng = random.Random(
            init_seed ^ 0x105E7 if init_seed is not None else None
        )
        self._order: list[int] = []  # global indices, current window only
        self._window_id = -1

    def _fill_window(self, window_id: int) -> None:
        lo = window_id * self._window
        hi = min(lo + self._window, len(self._base))
        decorated = sorted(
            (self._base.sort_key(g), self._rng.random(), g)
            for g in range(lo, hi)
        )
        ranked = [g for _, _, g in decorated]
        packs = [
            ranked[i : i + self._pack]
            for i in range(0, len(ranked), self._pack)
        ]
        self._rng.shuffle(packs)
        for pack in packs:
            self._rng.shuffle(pack)
        self._order = [g for pack in packs for g in pack]
        self._window_id = window_id

    def __getitem__(self, index: int) -> _T_co:
        window_id, offset = divmod(index, self._window)
        if self._window_id != window_id:
            self._fill_window(window_id)
        return self._base[self._order[offset]]

    def __len__(self) -> int:
        return len(self._base)

    def state_dict(self) -> dict[str, Any]:
        # base64-wrap the pickled RNG state: loader state rides the job
        # checkpoint's JSON meta item, which cannot carry raw bytes
        out: dict[str, Any] = {
            "rng": base64.b64encode(pickle.dumps(self._rng.getstate())).decode(),
            "window_id": self._window_id,
            "order": self._order,
        }
        if hasattr(self._base, "state_dict"):
            out["base_dataset"] = self._base.state_dict()
        return out

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        self._rng.setstate(pickle.loads(base64.b64decode(state_dict["rng"])))
        self._window_id = state_dict["window_id"]
        self._order = list(state_dict["order"])
        if hasattr(self._base, "load_state_dict"):
            self._base.load_state_dict(state_dict["base_dataset"])
