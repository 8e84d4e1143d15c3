"""Experiment tracker abstraction (counterpart of
``d9d_tpu/tracker/base.py``): a tracker opens a run; the run takes scalars
and pre-binned histograms under hierarchical names with a context-tag dict.
Run-hash persistence lives in ``state_dict`` / ``load_state_dict`` so a
resumed job continues the same tracker run."""

import abc
from typing import Any


class TrackerRun(abc.ABC):
    @abc.abstractmethod
    def track_scalar(self, name: str, value: float, *, step: int,
                     context: dict[str, str] | None = None) -> None: ...

    @abc.abstractmethod
    def track_histogram(self, name: str, counts: Any, bin_edges: Any, *,
                        step: int,
                        context: dict[str, str] | None = None) -> None:
        """Pre-binned histogram: len(bin_edges) == len(counts) + 1."""

    def track_hparams(self, hparams: dict[str, Any]) -> None:
        """Optional one-shot hyperparameter dump."""

    def close(self) -> None: ...

    # resume support ---------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        return {}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        pass


class Tracker(abc.ABC):
    @abc.abstractmethod
    def new_run(self, run_name: str | None = None) -> TrackerRun: ...
