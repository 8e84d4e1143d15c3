"""Device-mesh parameters and context (counterpart of
``d9d_tpu/core/mesh.py``): one device, or context parallelism over
processes.

The JAX package builds one named mesh over ``(pp, dp_r, dp_s, cp_s, cp_r,
tp)``. The port has two cases. With every axis of size 1 the context holds
the one ``torch.device`` the trainer places its model, batches and
optimizer state on. With ``cp_shard = N > 1`` (and every other axis 1) the
run is N processes, one rank each of the default process group that
``core.distributed.init_distributed`` started: the context holds that group
as the cp group, this rank's index on it, and this rank's device. Any other
axis larger than 1 raises ``NotImplementedError`` — the rest of the
multi-device mesh is a later slice (ROADMAP A3, A8).
"""

import dataclasses
from collections.abc import Sequence

import torch
import torch.distributed as dist

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
    validation). The all-ones mesh and the context-parallel one
    (``cp_shard`` alone larger than 1) can be built."""

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
        without one); a list holds one device per rank — tests pass
        ``["cpu"]``, or ``["cpu"] * N`` for N context-parallel processes —
        and this rank takes ``devices[rank]``. ``cp_shard > 1`` needs the
        default process group of exactly ``cp_shard`` ranks
        (``init_distributed``)."""
        big = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if getattr(self, f.name) > 1 and f.name != "cp_shard"}
        if big:
            raise NotImplementedError(
                f"multi-device meshes are not ported yet (axes {big}); the "
                f"port trains on one device, or with cp_shard alone over "
                f"processes"
            )
        rank, group = 0, None
        if self.cp_shard > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"cp_shard={self.cp_shard} needs a process group: call "
                    f"init_distributed(rank=..., world_size={self.cp_shard}, "
                    f"...) in every process first")
            if dist.get_world_size() != self.world_size:
                raise RuntimeError(
                    f"mesh of {self.world_size} ranks over a process group "
                    f"of {dist.get_world_size()}")
            rank, group = dist.get_rank(), dist.group.WORLD
        if devices is None:
            device = resolve_device(None)
        else:
            devices = list(devices)
            if len(devices) != self.world_size:
                raise ValueError(
                    f"mesh needs {self.world_size} device(s), one per rank, "
                    f"got {len(devices)}")
            device = resolve_device(devices[rank])
        if group is not None and device.type == "cuda":
            # NCCL's point-to-point calls run on the current device
            torch.cuda.set_device(device)
        return MeshContext(params=self, device=device, cp_group=group,
                           cp_rank=rank)


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A built mesh: this rank's device, the JAX context's axis vocabulary,
    and for ``cp_shard > 1`` the cp process group (``None`` for one device)
    and this rank's index on it — rank ``i`` owns sequence positions
    ``[i·T/cp, (i+1)·T/cp)`` of every batch."""

    params: MeshParameters
    device: torch.device
    cp_group: "dist.ProcessGroup | None" = None
    cp_rank: int = 0

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return (AXIS_DP_REPLICATE, AXIS_DP_SHARD)

    @property
    def sequence_axes(self) -> tuple[str, ...]:
        """Axes over which the sequence dim is split (context parallel)."""
        return (AXIS_CP_SHARD,)

    @property
    def cp_size(self) -> int:
        return self.params.cp_shard

    def axis_size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.params.axis_sizes[MESH_AXIS_NAMES.index(a)]
        return n

    @property
    def pp_size(self) -> int:
        return self.params.pp
