"""Schedule factory: schedule config → program builder (counterpart of
``d9d_tpu/pipelining/factory.py``).

The seven schedule configs have the JAX package's fields and defaults, as
frozen dataclasses with a ``type`` tag instead of pydantic models with a
``kind`` discriminator (the tags are the same words). "Building" a
schedule is composing the program, injecting the transfers and validating
it; the executor is wired by the loop (``loop/pipeline_driver.py``).

The port has one runtime, the per-action executor (``runtime/executor.py``,
JAX's ``runtime="legacy"``), so the configs have no ``runtime`` field. A
dict may still carry JAX's key: "legacy" is dropped, "fused" (JAX's
compiled-run executor; here one CUDA graph per fused run) raises as
ROADMAP A8.2.
"""

import dataclasses
from typing import Union

from d9d_tpu_torch.pipelining.program.builders import (
    DualPipeVProgramBuilder,
    GPipeProgramBuilder,
    Interleaved1F1BProgramBuilder,
    InferenceProgramBuilder,
    LoopedBFSProgramBuilder,
    ProgramBuilder,
    ZeroBubbleVProgramBuilder,
)

RESIDUAL_POLICIES = ("remat", "cache_full", "cache_acts")


@dataclasses.dataclass(frozen=True)
class _ScheduleConfig:
    def __post_init__(self) -> None:
        policy = getattr(self, "residual_policy", None)
        if policy is not None and policy not in RESIDUAL_POLICIES:
            raise ValueError(f"residual_policy must be one of "
                             f"{RESIDUAL_POLICIES}, got {policy!r}")
        spr = getattr(self, "stages_per_rank", 1)
        if not isinstance(spr, int) or spr < 1:
            raise ValueError(f"stages_per_rank must be an int >= 1, got "
                             f"{spr!r}")


@dataclasses.dataclass(frozen=True)
class GPipeScheduleConfig(_ScheduleConfig):
    type: str = "gpipe"
    residual_policy: str = "remat"


@dataclasses.dataclass(frozen=True)
class InferenceScheduleConfig(_ScheduleConfig):
    type: str = "inference"
    stages_per_rank: int = 1


@dataclasses.dataclass(frozen=True)
class LoopedBFSScheduleConfig(_ScheduleConfig):
    type: str = "looped_bfs"
    residual_policy: str = "remat"
    stages_per_rank: int = 1


@dataclasses.dataclass(frozen=True)
class Interleaved1F1BScheduleConfig(_ScheduleConfig):
    type: str = "interleaved_1f1b"
    residual_policy: str = "remat"
    stages_per_rank: int = 1


# the zero-bubble schedules default to cache_full, as in the JAX package
@dataclasses.dataclass(frozen=True)
class ZeroBubble1PScheduleConfig(_ScheduleConfig):
    type: str = "zero_bubble_1p"
    residual_policy: str = "cache_full"
    stages_per_rank: int = 1


@dataclasses.dataclass(frozen=True)
class ZeroBubbleVScheduleConfig(_ScheduleConfig):
    type: str = "zero_bubble_v"
    residual_policy: str = "cache_full"


@dataclasses.dataclass(frozen=True)
class DualPipeVScheduleConfig(_ScheduleConfig):
    type: str = "dual_pipe_v"
    residual_policy: str = "cache_full"


PipelineScheduleConfig = Union[
    GPipeScheduleConfig,
    InferenceScheduleConfig,
    LoopedBFSScheduleConfig,
    Interleaved1F1BScheduleConfig,
    ZeroBubble1PScheduleConfig,
    ZeroBubbleVScheduleConfig,
    DualPipeVScheduleConfig,
]

SCHEDULE_CONFIGS = {
    c.type: c for c in (
        GPipeScheduleConfig(), InferenceScheduleConfig(),
        LoopedBFSScheduleConfig(), Interleaved1F1BScheduleConfig(),
        ZeroBubble1PScheduleConfig(), ZeroBubbleVScheduleConfig(),
        DualPipeVScheduleConfig())
}


def schedule_config(value) -> PipelineScheduleConfig:
    """A schedule config from itself or from a dict with its ``type`` (the
    other keys its fields); raises on an unknown type or field."""
    if isinstance(value, tuple(type(c) for c in SCHEDULE_CONFIGS.values())):
        return value
    if not isinstance(value, dict) or "type" not in value:
        raise TypeError(f"a pipeline schedule is a schedule config or a dict "
                        f"with its 'type', got {value!r}")
    kind = value["type"]
    if kind not in SCHEDULE_CONFIGS:
        raise ValueError(f"unknown pipeline schedule type {kind!r} (known: "
                         f"{sorted(SCHEDULE_CONFIGS)})")
    runtime = value.get("runtime", "legacy")
    if runtime == "fused":
        raise NotImplementedError(
            "the fused pipeline runtime is not ported (ROADMAP A8.2); the "
            "port runs the per-action executor, runtime='legacy'")
    if runtime != "legacy":
        raise ValueError(f"runtime must be 'fused' or 'legacy', got "
                         f"{runtime!r}")
    return dataclasses.replace(SCHEDULE_CONFIGS[kind], **{
        k: v for k, v in value.items() if k not in ("type", "runtime")})


def build_program_builder(
    config: PipelineScheduleConfig, pp: int
) -> ProgramBuilder:
    if isinstance(config, GPipeScheduleConfig):
        return GPipeProgramBuilder(pp)
    if isinstance(config, InferenceScheduleConfig):
        return InferenceProgramBuilder(pp, config.stages_per_rank)
    if isinstance(config, LoopedBFSScheduleConfig):
        return LoopedBFSProgramBuilder(pp, config.stages_per_rank)
    if isinstance(config, Interleaved1F1BScheduleConfig):
        return Interleaved1F1BProgramBuilder(pp, config.stages_per_rank)
    if isinstance(config, ZeroBubble1PScheduleConfig):
        return Interleaved1F1BProgramBuilder(
            pp, config.stages_per_rank, zero_bubble=True
        )
    if isinstance(config, ZeroBubbleVScheduleConfig):
        return ZeroBubbleVProgramBuilder(pp)
    if isinstance(config, DualPipeVScheduleConfig):
        return DualPipeVProgramBuilder(pp)
    raise TypeError(f"unknown schedule config {config!r}")


__all__ = [
    "DualPipeVScheduleConfig",
    "GPipeScheduleConfig",
    "Interleaved1F1BScheduleConfig",
    "InferenceScheduleConfig",
    "LoopedBFSScheduleConfig",
    "PipelineScheduleConfig",
    "ZeroBubble1PScheduleConfig",
    "ZeroBubbleVScheduleConfig",
    "build_program_builder",
    "schedule_config",
]
