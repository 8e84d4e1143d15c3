"""Fluent builder for multiphase LR schedules (counterpart of
``d9d_tpu/lr_scheduler/builder.py``): ``for_steps`` / ``until_percentage``
/ ``fill_rest``; ``build`` gives a ``step -> multiplier`` schedule."""

from collections.abc import Callable

from d9d_tpu_torch.lr_scheduler.curves import ScheduleCurve
from d9d_tpu_torch.lr_scheduler.engine import (
    PiecewiseScheduleEngine,
    SchedulePhase,
)

Schedule = Callable[[int], float]


class PiecewiseScheduleBuilder:
    """Accumulates phases left to right; the cursor (step, multiplier)
    always sits at the end of the last phase added."""

    def __init__(self, initial_multiplier: float, total_steps: int | None):
        self._phases: list[SchedulePhase] = []
        self._total_steps = total_steps
        self._cursor = (0, initial_multiplier)

    def _push(self, steps: int, target: float, curve: ScheduleCurve) -> None:
        at, value = self._cursor
        self._phases.append(SchedulePhase(
            start_step=at, end_step=at + steps, start_value=value,
            end_value=target, curve=curve))
        self._cursor = (at + steps, target)

    def for_steps(self, steps: int, target_multiplier: float,
                  curve: ScheduleCurve) -> "PiecewiseScheduleBuilder":
        self._push(steps, target_multiplier, curve)
        return self

    def until_percentage(self, p: float, target_multiplier: float,
                         curve: ScheduleCurve) -> "PiecewiseScheduleBuilder":
        if self._total_steps is None:
            raise ValueError(
                "percentage-based phases need the builder constructed with "
                "total_steps")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"phase end fraction {p} outside [0, 1]")
        end_step = int(self._total_steps * p)
        at, _ = self._cursor
        if end_step < at:
            raise ValueError(
                f"phase ending at fraction {p} (step {end_step}) precedes "
                f"the schedule cursor (step {at})")
        self._push(end_step - at, target_multiplier, curve)
        return self

    def fill_rest(self, target_multiplier: float,
                  curve: ScheduleCurve) -> "PiecewiseScheduleBuilder":
        return self.until_percentage(1.0, target_multiplier, curve)

    def build(self) -> PiecewiseScheduleEngine:
        """Finalize into a ``step -> multiplier`` schedule."""
        at, _ = self._cursor
        if self._total_steps is not None and at > self._total_steps:
            raise ValueError(
                f"phases cover {at} steps but the schedule was declared for "
                f"{self._total_steps}")
        return PiecewiseScheduleEngine(self._phases)

def piecewise_schedule(initial_multiplier: float,
                       total_steps: int | None = None) -> PiecewiseScheduleBuilder:
    return PiecewiseScheduleBuilder(initial_multiplier, total_steps)
