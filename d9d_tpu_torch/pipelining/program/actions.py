"""Immutable pipeline action algebra (a copy of
``d9d_tpu/pipelining/program/actions.py``, which imports no JAX).

Reference: d9d/pipelining/runtime/action.py:80-335 — every schedule
compiles to a ``dict[rank, list[Action]]`` program interpreted by a dumb
executor VM. The port's executor (``runtime/executor.py``) walks it with
point-to-point transfers at the Send/Recv actions, as the reference does.

Action vocabulary (mirroring action.py):
- ``ForwardCompute``       — run stage forward for one microbatch
- ``BackwardFull``         — fused dI+dW backward
- ``BackwardInput``        — input-only backward (zero-bubble split, "B")
- ``BackwardWeight``       — weight-only backward (zero-bubble split, "W")
- ``ForwardSend/Recv``     — activation transfer stage → stage+1
- ``BackwardSend/Recv``    — cotangent transfer stage → stage-1
- ``Compose``              — execute several actions as one overlapped slot
  (DualPipeV's joint forward+backward block)
"""

import dataclasses
from typing import Union

__all__ = [
    "Action",
    "BackwardFull",
    "BackwardInput",
    "BackwardRecv",
    "BackwardSend",
    "BackwardWeight",
    "Compose",
    "ComputeAction",
    "ForwardCompute",
    "ForwardRecv",
    "ForwardSend",
    "PipelineProgram",
    "format_program",
]


@dataclasses.dataclass(frozen=True)
class _StageMicrobatch:
    """Every primitive action is addressed by (global stage id, microbatch)."""

    stage: int
    microbatch: int

    def __post_init__(self) -> None:
        if self.stage < 0 or self.microbatch < 0:
            raise ValueError(f"invalid action address {self}")


class ForwardCompute(_StageMicrobatch):
    def __str__(self) -> str:
        return f"F{self.stage}.{self.microbatch}"


class BackwardFull(_StageMicrobatch):
    """Fused backward: produces both input-grad and weight-grad."""

    def __str__(self) -> str:
        return f"B{self.stage}.{self.microbatch}"


class BackwardInput(_StageMicrobatch):
    """Input-only backward (zero-bubble 'B'); weight grad deferred."""

    def __str__(self) -> str:
        return f"I{self.stage}.{self.microbatch}"


class BackwardWeight(_StageMicrobatch):
    """Deferred weight-only backward (zero-bubble 'W')."""

    def __str__(self) -> str:
        return f"W{self.stage}.{self.microbatch}"


class ForwardSend(_StageMicrobatch):
    """Send ``stage``'s forward output for ``microbatch`` to stage+1's rank."""

    def __str__(self) -> str:
        return f"FS{self.stage}.{self.microbatch}"


class ForwardRecv(_StageMicrobatch):
    """Receive ``stage``'s forward *input* for ``microbatch`` (from stage-1)."""

    def __str__(self) -> str:
        return f"FR{self.stage}.{self.microbatch}"


class BackwardSend(_StageMicrobatch):
    """Send grad w.r.t. ``stage``'s input for ``microbatch`` to stage-1's rank."""

    def __str__(self) -> str:
        return f"BS{self.stage}.{self.microbatch}"


class BackwardRecv(_StageMicrobatch):
    """Receive grad w.r.t. ``stage``'s *output* for ``microbatch`` (from stage+1)."""

    def __str__(self) -> str:
        return f"BR{self.stage}.{self.microbatch}"


@dataclasses.dataclass(frozen=True)
class Compose:
    """Several actions executed as one schedule slot (overlap bundle).

    Reference ComposeAction (action.py:300-335): DualPipeV issues a joint
    forward+backward block so the executor can overlap the two directions.
    """

    actions: tuple["Action", ...]

    def __str__(self) -> str:
        return "(" + "+".join(str(a) for a in self.actions) + ")"


ComputeAction = Union[ForwardCompute, BackwardFull, BackwardInput, BackwardWeight]
Action = Union[
    ForwardCompute,
    BackwardFull,
    BackwardInput,
    BackwardWeight,
    ForwardSend,
    ForwardRecv,
    BackwardSend,
    BackwardRecv,
    Compose,
]

#: A compiled schedule: per-pp-rank ordered action list.
PipelineProgram = dict[int, list[Action]]


def format_program(program: PipelineProgram) -> str:
    """Human-readable program dump (one line per rank) for tests/debugging."""
    lines = []
    for rank in sorted(program):
        lines.append(f"rank {rank}: " + " ".join(str(a) for a in program[rank]))
    return "\n".join(lines)
