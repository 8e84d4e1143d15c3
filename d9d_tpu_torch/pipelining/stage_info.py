"""Pipeline stage identity and layer distribution (a copy of
``d9d_tpu/pipelining/stage_info.py``).

Reference: d9d/pipelining/api/module.py:8 (``PipelineStageInfo``) and
:38-102 (``distribute_layers_for_pipeline_stage`` — virtual-stage aware).
Models consume this to build only their slice of the layer stack; it is
meaningful even without a pipeline runtime (num_stages=1 = whole model).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineStageInfo:
    """Identity of one stage in a pipeline of ``num_stages`` stages.

    With interleaved (looped/V) schedules a rank holds several *virtual*
    stages; ``stage_index`` numbers stages globally in topological order.
    """

    stage_index: int = 0
    num_stages: int = 1

    def __post_init__(self) -> None:
        if not 0 <= self.stage_index < self.num_stages:
            raise ValueError(
                f"stage_index {self.stage_index} out of range for "
                f"{self.num_stages} stages"
            )

    @property
    def is_first(self) -> bool:
        return self.stage_index == 0

    @property
    def is_last(self) -> bool:
        return self.stage_index == self.num_stages - 1


def distribute_layers_for_pipeline_stage(
    num_layers: int, stage: PipelineStageInfo
) -> range:
    """Global layer ids owned by ``stage``.

    Layers are split as evenly as possible; the *later* stages get the
    smaller shares (first stages also own embeddings, but embeddings are
    cheap next to a layer — matching the reference's bias of giving
    remainder layers to earlier stages, api/module.py:38-102).
    """
    base, rem = divmod(num_layers, stage.num_stages)
    sizes = [base + (1 if i < rem else 0) for i in range(stage.num_stages)]
    start = sum(sizes[: stage.stage_index])
    return range(start, start + sizes[stage.stage_index])
