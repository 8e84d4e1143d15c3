from d9d_tpu_torch.tracker.base import Tracker, TrackerRun
from d9d_tpu_torch.tracker.providers import NullTracker, NullTrackerRun

__all__ = ["NullTracker", "NullTrackerRun", "Tracker", "TrackerRun"]
