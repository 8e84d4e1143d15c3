"""The pipeline runtime: the stage (``stage.py``), the point-to-point
transfers (``transfer.py``) and the executor (``executor.py``)."""

from d9d_tpu_torch.pipelining.runtime.executor import (
    PipelineExecutionResult,
    PipelineScheduleExecutor,
)
from d9d_tpu_torch.pipelining.runtime.stage import (
    PipelineStageRuntime,
    StageTask,
)
from d9d_tpu_torch.pipelining.runtime.transfer import (
    CarrySpec,
    P2PTransfer,
    p2p_counters,
)

__all__ = [
    "CarrySpec",
    "P2PTransfer",
    "PipelineExecutionResult",
    "PipelineScheduleExecutor",
    "PipelineStageRuntime",
    "StageTask",
    "p2p_counters",
]
