"""Experiment trackers (counterpart of ``d9d_tpu/tracker``)."""

from d9d_tpu_torch.tracker.base import Tracker, TrackerRun
from d9d_tpu_torch.tracker.providers import (
    JsonlTracker,
    JsonlTrackerRun,
    MemoryTracker,
    MemoryTrackerRun,
    MirrorTrackerRun,
    NullTracker,
    NullTrackerRun,
    build_tracker,
)

__all__ = [
    "JsonlTracker",
    "JsonlTrackerRun",
    "MemoryTracker",
    "MemoryTrackerRun",
    "MirrorTrackerRun",
    "NullTracker",
    "NullTrackerRun",
    "Tracker",
    "TrackerRun",
    "build_tracker",
]
