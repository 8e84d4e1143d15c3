"""Interpolation curves for piecewise LR schedules (counterpart of
``d9d_tpu/lr_scheduler/curves.py``). Each curve maps a phase-progress
fraction ``frac`` in [0, 1] to a value between the phase's start ``lo`` and
end ``hi``. The arithmetic is numpy float32, as the JAX curves compute in
float32, so a schedule gives the JAX package's learning rates to the bit
where numpy and XLA round alike."""

import abc
import dataclasses

import numpy as np

_F = np.float32


class ScheduleCurve(abc.ABC):
    @abc.abstractmethod
    def blend(self, lo: float, hi: float, frac: np.ndarray) -> np.ndarray: ...


class LinearInterp(ScheduleCurve):
    """Straight-line blend from ``lo`` to ``hi``."""

    def blend(self, lo, hi, frac):
        return _F(lo) + (_F(hi) - _F(lo)) * frac


class CosineAnneal(ScheduleCurve):
    """Half-period cosine annealing from ``lo`` to ``hi``."""

    def blend(self, lo, hi, frac):
        mix = (_F(1.0) + np.cos(_F(np.pi) * frac)) / _F(2.0)
        return _F(hi) + (_F(lo) - _F(hi)) * mix


@dataclasses.dataclass(frozen=True)
class PowerInterp(ScheduleCurve):
    """Power-law blend; ``power=1`` is linear, 2 quadratic, etc."""

    power: float = 2.0

    def blend(self, lo, hi, frac):
        return _F(lo) + (_F(hi) - _F(lo)) * frac ** _F(self.power)


class LogSpaceInterp(ScheduleCurve):
    """Log-space linear blend (operands clamped away from zero)."""

    def blend(self, lo, hi, frac):
        tiny = _F(1e-8)
        log_lo = np.log(np.maximum(_F(lo), tiny))
        log_hi = np.log(np.maximum(_F(hi), tiny))
        return np.exp(log_lo + (log_hi - log_lo) * frac)
