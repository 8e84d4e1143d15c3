"""Pipeline parallelism (counterpart of ``d9d_tpu/pipelining``): the
schedule programs (``program/``), the schedule configs (``factory.py``),
the stage identity (``stage_info.py``), the runtime (``runtime/``) and the
per-stage optimizer (``training.py``). JAX's fused runtime
(``runtime/fused.py``) is not ported (ROADMAP A8.2)."""

from d9d_tpu_torch.pipelining.factory import (
    DualPipeVScheduleConfig,
    GPipeScheduleConfig,
    Interleaved1F1BScheduleConfig,
    InferenceScheduleConfig,
    LoopedBFSScheduleConfig,
    PipelineScheduleConfig,
    ZeroBubble1PScheduleConfig,
    ZeroBubbleVScheduleConfig,
    build_program_builder,
    schedule_config,
)
from d9d_tpu_torch.pipelining.runtime import (
    PipelineExecutionResult,
    PipelineScheduleExecutor,
    PipelineStageRuntime,
    StageTask,
)
from d9d_tpu_torch.pipelining.stage_info import (
    PipelineStageInfo,
    distribute_layers_for_pipeline_stage,
)

__all__ = [
    "DualPipeVScheduleConfig",
    "GPipeScheduleConfig",
    "Interleaved1F1BScheduleConfig",
    "InferenceScheduleConfig",
    "LoopedBFSScheduleConfig",
    "PipelineExecutionResult",
    "PipelineScheduleConfig",
    "PipelineScheduleExecutor",
    "PipelineStageInfo",
    "PipelineStageRuntime",
    "StageTask",
    "ZeroBubble1PScheduleConfig",
    "ZeroBubbleVScheduleConfig",
    "build_program_builder",
    "distribute_layers_for_pipeline_stage",
    "schedule_config",
]
