from d9d_tpu_torch.lr_scheduler.builder import (
    PiecewiseScheduleBuilder,
    Schedule,
    piecewise_schedule,
)
from d9d_tpu_torch.lr_scheduler.config import (
    CurveCosineConfig,
    CurveExponentialConfig,
    CurveLinearConfig,
    CurvePolyConfig,
    PercentagePhaseConfig,
    PiecewiseSchedulerConfig,
    RestPhaseConfig,
    StepPhaseConfig,
    curve_from_config,
    piecewise_scheduler_from_config,
)
from d9d_tpu_torch.lr_scheduler.curves import (
    CosineAnneal,
    LinearInterp,
    LogSpaceInterp,
    PowerInterp,
    ScheduleCurve,
)
from d9d_tpu_torch.lr_scheduler.engine import (
    PiecewiseScheduleEngine,
    SchedulePhase,
)

__all__ = [
    "CosineAnneal",
    "CurveCosineConfig",
    "CurveExponentialConfig",
    "CurveLinearConfig",
    "CurvePolyConfig",
    "LinearInterp",
    "LogSpaceInterp",
    "PercentagePhaseConfig",
    "PiecewiseScheduleBuilder",
    "PiecewiseScheduleEngine",
    "PiecewiseSchedulerConfig",
    "PowerInterp",
    "RestPhaseConfig",
    "Schedule",
    "ScheduleCurve",
    "SchedulePhase",
    "StepPhaseConfig",
    "curve_from_config",
    "piecewise_schedule",
    "piecewise_scheduler_from_config",
]
