"""Schedule programs: the action algebra, the builders, the
communication pass and the simulator (copies of
``d9d_tpu/pipelining/program``, which imports no JAX)."""

from d9d_tpu_torch.pipelining.program.actions import (
    Action,
    BackwardFull,
    BackwardInput,
    BackwardRecv,
    BackwardSend,
    BackwardWeight,
    Compose,
    ForwardCompute,
    ForwardRecv,
    ForwardSend,
    PipelineProgram,
    format_program,
)
from d9d_tpu_torch.pipelining.program.builders import (
    DualPipeVProgramBuilder,
    GPipeProgramBuilder,
    Interleaved1F1BProgramBuilder,
    InferenceProgramBuilder,
    LoopedBFSProgramBuilder,
    ProgramBuilder,
)
from d9d_tpu_torch.pipelining.program.builders import ZeroBubbleVProgramBuilder
from d9d_tpu_torch.pipelining.program.communications import add_communication_ops
from d9d_tpu_torch.pipelining.program.topology import (
    ScheduleStyle,
    ranks_to_stages,
    stage_to_rank,
)
from d9d_tpu_torch.pipelining.program.validate import (
    SimulatedProgram,
    simulate_program,
    validate_program,
)

__all__ = [
    "Action",
    "BackwardFull",
    "BackwardInput",
    "BackwardRecv",
    "BackwardSend",
    "BackwardWeight",
    "Compose",
    "DualPipeVProgramBuilder",
    "ForwardCompute",
    "ForwardRecv",
    "ForwardSend",
    "GPipeProgramBuilder",
    "Interleaved1F1BProgramBuilder",
    "InferenceProgramBuilder",
    "LoopedBFSProgramBuilder",
    "PipelineProgram",
    "ProgramBuilder",
    "ScheduleStyle",
    "SimulatedProgram",
    "ZeroBubbleVProgramBuilder",
    "add_communication_ops",
    "format_program",
    "ranks_to_stages",
    "simulate_program",
    "stage_to_rank",
    "validate_program",
]
