"""Global-batch ↔ microbatch arithmetic (counterpart of
``d9d_tpu/loop/components/batch_maths.py``). ``dp_size`` is the product of
the mesh's batch axes (``dp_r x dp_s``): every microbatch is split evenly
over them (``batch_staging.py``)."""

import dataclasses

from d9d_tpu_torch.core.mesh import MeshContext


@dataclasses.dataclass(frozen=True)
class BatchMaths:
    global_batch_size: int
    microbatch_size: int
    dp_size: int

    def __post_init__(self) -> None:
        if self.global_batch_size % self.microbatch_size != 0:
            raise ValueError(
                f"global_batch_size {self.global_batch_size} not divisible by "
                f"microbatch_size {self.microbatch_size}")
        if self.microbatch_size % self.dp_size != 0:
            raise ValueError(
                f"microbatch_size {self.microbatch_size} (global across DP) "
                f"not divisible by dp_size {self.dp_size}")

    @staticmethod
    def from_context(ctx: MeshContext, global_batch_size: int,
                     microbatch_size: int) -> "BatchMaths":
        return BatchMaths(global_batch_size=global_batch_size,
                          microbatch_size=microbatch_size,
                          dp_size=ctx.axis_size(*ctx.batch_axes))

    @property
    def num_microbatches(self) -> int:
        """Gradient-accumulation steps per optimizer step."""
        return self.global_batch_size // self.microbatch_size
