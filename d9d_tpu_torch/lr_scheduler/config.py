"""Declarative configuration of piecewise LR schedules (counterpart of
``d9d_tpu/lr_scheduler/config.py``): the same curves {linear, cosine,
exponential, poly} and phases {steps, percentage, rest}, as frozen
dataclasses with a ``type`` / ``mode`` tag instead of pydantic models."""

import dataclasses
from typing import Union

from d9d_tpu_torch.lr_scheduler.builder import piecewise_schedule
from d9d_tpu_torch.lr_scheduler.curves import (
    CosineAnneal,
    LinearInterp,
    LogSpaceInterp,
    PowerInterp,
    ScheduleCurve,
)
from d9d_tpu_torch.lr_scheduler.engine import PiecewiseScheduleEngine


@dataclasses.dataclass(frozen=True)
class CurveLinearConfig:
    type: str = "linear"


@dataclasses.dataclass(frozen=True)
class CurveCosineConfig:
    type: str = "cosine"


@dataclasses.dataclass(frozen=True)
class CurveExponentialConfig:
    type: str = "exponential"


@dataclasses.dataclass(frozen=True)
class CurvePolyConfig:
    type: str = "poly"
    power: float = 2.0


AnyCurveConfig = Union[CurveLinearConfig, CurveCosineConfig,
                       CurveExponentialConfig, CurvePolyConfig]


def curve_from_config(config: AnyCurveConfig) -> ScheduleCurve:
    match config:
        case CurveLinearConfig():
            return LinearInterp()
        case CurvePolyConfig():
            return PowerInterp(config.power)
        case CurveExponentialConfig():
            return LogSpaceInterp()
        case CurveCosineConfig():
            return CosineAnneal()
    raise TypeError(f"unknown curve config: {config!r}")


@dataclasses.dataclass(frozen=True)
class StepPhaseConfig:
    steps: int
    target_multiplier: float
    curve: AnyCurveConfig
    mode: str = "steps"

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"steps must be positive, got {self.steps}")


@dataclasses.dataclass(frozen=True)
class PercentagePhaseConfig:
    percentage: float
    target_multiplier: float
    curve: AnyCurveConfig
    mode: str = "percentage"

    def __post_init__(self):
        if not 0.0 <= self.percentage <= 1.0:
            raise ValueError(f"percentage {self.percentage} outside [0, 1]")


@dataclasses.dataclass(frozen=True)
class RestPhaseConfig:
    target_multiplier: float
    curve: AnyCurveConfig
    mode: str = "rest"


PhaseConfig = Union[StepPhaseConfig, PercentagePhaseConfig, RestPhaseConfig]


@dataclasses.dataclass(frozen=True)
class PiecewiseSchedulerConfig:
    initial_multiplier: float
    phases: tuple[PhaseConfig, ...]


def piecewise_scheduler_from_config(
    config: PiecewiseSchedulerConfig, total_steps: int | None
) -> PiecewiseScheduleEngine:
    """A ``step -> multiplier`` schedule from ``config``."""
    builder = piecewise_schedule(config.initial_multiplier, total_steps)
    for phase in config.phases:
        curve = curve_from_config(phase.curve)
        match phase:
            case StepPhaseConfig():
                builder.for_steps(phase.steps, phase.target_multiplier, curve)
            case PercentagePhaseConfig():
                builder.until_percentage(
                    phase.percentage, phase.target_multiplier, curve)
            case RestPhaseConfig():
                builder.fill_rest(phase.target_multiplier, curve)
    return builder.build()
