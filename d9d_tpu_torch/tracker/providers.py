"""Tracker providers (counterpart of ``d9d_tpu/tracker/providers.py``):
the null tracker only. The JAX package's in-memory, JSONL and Aim trackers
are not ported yet."""

from d9d_tpu_torch.tracker.base import Tracker, TrackerRun


class NullTrackerRun(TrackerRun):
    def track_scalar(self, name, value, *, step, context=None):
        pass

    def track_histogram(self, name, counts, bin_edges, *, step, context=None):
        pass


class NullTracker(Tracker):
    def new_run(self, run_name=None):
        return NullTrackerRun()
