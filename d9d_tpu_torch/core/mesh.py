"""Device-mesh parameters and context (counterpart of
``d9d_tpu/core/mesh.py``), one device only.

The JAX package builds one named mesh over ``(pp, dp_r, dp_s, cp_s, cp_r,
tp)``. The port has the single-device case: every axis has size 1 and the
context holds the one ``torch.device`` the trainer places its model, batches
and optimizer state on. Any axis larger than 1 raises
``NotImplementedError`` — the multi-device mesh is a later slice.
"""

import dataclasses
from collections.abc import Sequence

import torch

from d9d_tpu_torch.core.device import resolve_device

AXIS_PP = "pp"
AXIS_DP_REPLICATE = "dp_r"
AXIS_DP_SHARD = "dp_s"
AXIS_CP_SHARD = "cp_s"
AXIS_CP_REPLICATE = "cp_r"
AXIS_TP = "tp"

MESH_AXIS_NAMES: tuple[str, ...] = (
    AXIS_PP,
    AXIS_DP_REPLICATE,
    AXIS_DP_SHARD,
    AXIS_CP_SHARD,
    AXIS_CP_REPLICATE,
    AXIS_TP,
)


@dataclasses.dataclass(frozen=True)
class MeshParameters:
    """Sizes of every parallelism dimension (the JAX class's fields and
    validation). Only the all-ones mesh can be built."""

    pp: int = 1
    dp_replicate: int = 1
    dp_shard: int = 1
    cp_shard: int = 1
    cp_replicate: int = 1
    tp: int = 1
    ep_shard: int = 1

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{f.name} must be a positive int, got {v!r}")
        non_pp = (self.dp_replicate * self.dp_shard * self.cp_shard
                  * self.cp_replicate * self.tp)
        if non_pp % self.ep_shard != 0:
            raise ValueError(
                f"ep_shard={self.ep_shard} must divide "
                f"dp_replicate*dp_shard*cp_shard*cp_replicate*tp={non_pp}"
            )

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return (self.pp, self.dp_replicate, self.dp_shard, self.cp_shard,
                self.cp_replicate, self.tp)

    @property
    def world_size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def build(
        self, devices: "Sequence[torch.device | str] | None" = None
    ) -> "MeshContext":
        """The context over ``devices``: ``None`` means the card (raises
        without one); a list must hold exactly one device — tests pass
        ``["cpu"]``."""
        big = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if getattr(self, f.name) > 1}
        if big:
            raise NotImplementedError(
                f"multi-device meshes are not ported yet (axes {big}); the "
                f"port trains on one device"
            )
        if devices is None:
            device = resolve_device(None)
        else:
            devices = list(devices)
            if len(devices) != 1:
                raise ValueError(
                    f"mesh needs {self.world_size} device, got {len(devices)}")
            device = resolve_device(devices[0])
        return MeshContext(params=self, device=device)


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A built (one-device) mesh: the device, and the JAX context's axis
    vocabulary, every group of which has size 1."""

    params: MeshParameters
    device: torch.device

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return (AXIS_DP_REPLICATE, AXIS_DP_SHARD)

    def axis_size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.params.axis_sizes[MESH_AXIS_NAMES.index(a)]
        return n

    @property
    def pp_size(self) -> int:
        return self.params.pp
