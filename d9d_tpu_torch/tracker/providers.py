"""Tracker providers (counterpart of ``d9d_tpu/tracker/providers.py``):
the null, in-memory and JSONL trackers, and ``build_tracker``.

The JAX package's Aim tracker is not ported (it needs the ``aim`` package,
which the card's machine lacks): ``build_tracker("aim")`` takes the JAX
factory's path when ``aim`` is missing (a warning and the null tracker) and
raises when it is installed. :class:`MirrorTrackerRun` is the port's own:
on a mesh of processes rank 0 alone writes the run, and every other rank
holds a run that writes nothing but carries rank 0's state (its run hash),
so every rank's checkpoint meta agrees.
"""

import json
import logging
import time
import uuid
from pathlib import Path
from typing import Any

import numpy as np

from d9d_tpu_torch.tracker.base import Tracker, TrackerRun

logger = logging.getLogger("d9d_tpu_torch.tracker")


class NullTrackerRun(TrackerRun):
    def track_scalar(self, name, value, *, step, context=None):
        pass

    def track_histogram(self, name, counts, bin_edges, *, step, context=None):
        pass


class NullTracker(Tracker):
    def new_run(self, run_name=None):
        return NullTrackerRun()


class MirrorTrackerRun(NullTrackerRun):
    """Writes nothing; holds the state of the run rank 0 writes (its
    ``state_dict``), so that a checkpoint's meta is the same on every
    rank and a restore re-points it as it re-points rank 0's."""

    def __init__(self, state: dict[str, Any]):
        self._state = dict(state)

    def state_dict(self):
        return dict(self._state)

    def load_state_dict(self, state):
        self._state = dict(state)


class MemoryTrackerRun(TrackerRun):
    """Keeps everything in lists — the test/debug tracker."""

    def __init__(self, run_hash: str | None = None, run_name: str | None = None):
        self.run_hash = run_hash or uuid.uuid4().hex
        self.run_name = run_name
        self.scalars: list[dict[str, Any]] = []
        self.histograms: list[dict[str, Any]] = []
        self.hparams: dict[str, Any] = {}
        self.closed = False

    def track_scalar(self, name, value, *, step, context=None):
        self.scalars.append(
            {"name": name, "value": float(value), "step": step, "context": context or {}}
        )

    def track_histogram(self, name, counts, bin_edges, *, step, context=None):
        self.histograms.append(
            {
                "name": name,
                "counts": np.asarray(counts).tolist(),
                "bin_edges": np.asarray(bin_edges).tolist(),
                "step": step,
                "context": context or {},
            }
        )

    def track_hparams(self, hparams):
        self.hparams.update(hparams)

    def close(self):
        self.closed = True

    def state_dict(self):
        return {"run_hash": self.run_hash}

    def load_state_dict(self, state):
        self.run_hash = state.get("run_hash", self.run_hash)


class MemoryTracker(Tracker):
    def __init__(self):
        self.runs: list[MemoryTrackerRun] = []

    def new_run(self, run_name=None):
        run = MemoryTrackerRun(run_name=run_name)
        self.runs.append(run)
        return run


class JsonlTrackerRun(TrackerRun):
    """Appends one JSON object per tracked value to ``{dir}/{hash}.jsonl``."""

    def __init__(
        self,
        directory: Path,
        run_hash: str | None = None,
        run_name: str | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        # the name prefixes the file for humans; the hash keeps it unique
        # and is what resume re-points at
        self.run_hash = run_hash or (
            f"{run_name}-{uuid.uuid4().hex[:8]}" if run_name else uuid.uuid4().hex
        )
        self._fh = None

    @property
    def path(self) -> Path:
        return self.directory / f"{self.run_hash}.jsonl"

    def _file(self):
        if self._fh is None:
            self._fh = open(self.path, "a")
        return self._fh

    def _emit(self, obj: dict[str, Any]):
        obj["ts"] = time.time()
        self._file().write(json.dumps(obj) + "\n")
        self._file().flush()

    def track_scalar(self, name, value, *, step, context=None):
        self._emit(
            {"kind": "scalar", "name": name, "value": float(value), "step": step,
             "context": context or {}}
        )

    def track_histogram(self, name, counts, bin_edges, *, step, context=None):
        self._emit(
            {
                "kind": "histogram",
                "name": name,
                "counts": np.asarray(counts).tolist(),
                "bin_edges": np.asarray(bin_edges).tolist(),
                "step": step,
                "context": context or {},
            }
        )

    def track_hparams(self, hparams):
        self._emit({"kind": "hparams", "hparams": hparams})

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def state_dict(self):
        return {"run_hash": self.run_hash}

    def load_state_dict(self, state):
        new_hash = state.get("run_hash", self.run_hash)
        if new_hash != self.run_hash:
            # re-point the (possibly already opened) file at the restored run
            self.close()
            self.run_hash = new_hash


class JsonlTracker(Tracker):
    def __init__(self, directory: str | Path):
        self.directory = Path(directory)

    def new_run(self, run_name=None):
        return JsonlTrackerRun(self.directory, run_name=run_name)


def build_tracker(kind: str = "null", **kwargs) -> Tracker:
    """Factory with the JAX factory's contract: unknown providers, and Aim
    when ``aim`` is not installed, degrade to :class:`NullTracker` with a
    warning. With ``aim`` installed, ``"aim"`` raises: the Aim tracker is
    not ported."""
    if kind == "null":
        return NullTracker()
    if kind == "memory":
        return MemoryTracker()
    if kind == "jsonl":
        return JsonlTracker(**kwargs)
    if kind == "aim":
        try:
            import aim  # noqa: F401
        except ImportError:
            logger.warning("aim not installed; falling back to NullTracker")
            return NullTracker()
        raise NotImplementedError(
            "the Aim tracker is not ported (it needs the aim package, which "
            "the card's machine lacks); use kind='jsonl'")
    logger.warning("unknown tracker %r; falling back to NullTracker", kind)
    return NullTracker()
