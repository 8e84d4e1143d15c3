"""Piecewise schedule engine (counterpart of
``d9d_tpu/lr_scheduler/engine.py``): a callable ``step -> multiplier``,
evaluated on the host in float32. Out-of-range steps clamp to the nearest
boundary value; where two phases touch, the earlier one wins."""

import dataclasses

import numpy as np

from d9d_tpu_torch.lr_scheduler.curves import ScheduleCurve

_F = np.float32


@dataclasses.dataclass(frozen=True)
class SchedulePhase:
    """Interpolate ``start_value`` → ``end_value`` over ``[start_step,
    end_step)`` along ``curve``."""

    start_step: int
    end_step: int
    start_value: float
    end_value: float
    curve: ScheduleCurve


class PiecewiseScheduleEngine:
    def __init__(self, phases: list[SchedulePhase]):
        if len(phases) == 0:
            raise ValueError("Scheduler should contain at least one phase")
        self._phases = list(phases)

    def get_factor(self, step) -> np.ndarray:
        step = np.asarray(step, dtype=_F)
        out = np.full(step.shape, self._phases[-1].end_value, dtype=_F)
        for phase in reversed(self._phases):
            phase_len = _F(max(phase.end_step - phase.start_step, 1))
            progress = (step - _F(phase.start_step)) / phase_len
            value = phase.curve.blend(
                phase.start_value, phase.end_value,
                np.clip(progress, _F(0.0), _F(1.0)))
            inside = (step >= phase.start_step) & (step < phase.end_step)
            out = np.where(inside, value, out).astype(_F)
        first = self._phases[0]
        return np.where(step < first.start_step, _F(first.start_value),
                        out).astype(_F)

    def __call__(self, step) -> np.ndarray:
        return self.get_factor(step)
