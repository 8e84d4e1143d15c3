"""Device-mesh parameters and context (counterpart of
``d9d_tpu/core/mesh.py``).

The JAX package builds one named mesh over ``(pp, dp_r, dp_s, cp_s, cp_r,
tp)``; the port builds the same mesh as a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group
(``init_device_mesh``, row-major in that axis order, so rank ``r`` sits at
the coordinate whose flattened index is ``r``). Each rank is one process
with one device. The JAX context's axis groups (``dp_axes``,
``fsdp_axes``, ``grad_reduce_axes``, ...) are tuples of axis names here as
there; :meth:`MeshContext.group` turns any tuple of them into the process
group of the flattened sub-mesh and :meth:`MeshContext.coordinate` gives
this rank's index on it.

A mesh of one rank needs no process group and holds no ``DeviceMesh``:
every group is ``None`` and every coordinate 0. Of the axes, ``dp_r``,
``dp_s``, ``cp_s``, ``cp_r`` and ``tp`` can be larger than 1, and so can
the expert-shard overlay ``ep_shard``. ``pp`` may be larger than 1 beside
``dp_r`` and ``dp_s`` (the pipeline engine, ``loop/pipeline_driver.py``,
owns the stages of this rank's ``pp`` coordinate); beside ``cp_s``,
``cp_r``, ``tp`` or ``ep_shard`` it raises ``NotImplementedError`` naming
the ROADMAP item that ports it, before any process group is asked for.
Ranks along
``tp`` and ``cp_r`` hold the same rows and sequence chunk: ``tp`` cuts the
parameters (``parallel/plan.py``), ``cp_r`` replicates everything.

``ep_shard`` is no axis of its own: it names the fastest-varying suffix of
the non-pp axes whose sizes multiply to it (``ep_shard_axes``), as in the
JAX package. A rank's expert index (:attr:`MeshContext.ep_rank`) is
row-major over those axes in mesh order, which is the order of the JAX
devices under ``shard_map`` over them: a mesh coordinate owns the same
experts in both packages.
"""

import dataclasses
import functools
import math
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

# axes that may not exceed 1 beside pp > 1 yet (ROADMAP A8.2)
_NOT_WITH_PP = ("cp_shard", "cp_replicate", "tp", "ep_shard")


def _suffix_axes_covering(
    size: int, axes: Sequence[tuple[str, int]]
) -> tuple[str, ...]:
    """The fastest-varying (suffix) axes whose sizes multiply to ``size``;
    raises if ``size`` does not align with whole-axis boundaries."""
    if size == 1:
        return ()
    prod = 1
    chosen: list[str] = []
    for name, s in reversed(list(axes)):
        if prod >= size:
            break
        if s == 1:
            continue
        prod *= s
        chosen.append(name)
    if prod != size:
        raise ValueError(
            f"expert-shard size {size} does not factor into a suffix of mesh "
            f"axes {list(axes)}; got partial product {prod}"
        )
    return tuple(reversed(chosen))


@dataclasses.dataclass(frozen=True)
class MeshParameters:
    """Sizes of every parallelism dimension (the JAX class's fields and
    validation)."""

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

    def as_dict(self) -> dict:
        """JSON-serializable axis sizes (the JAX checkpoint manifest's mesh
        block)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshParameters":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in names})

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return (self.pp, self.dp_replicate, self.dp_shard, self.cp_shard,
                self.cp_replicate, self.tp)

    @property
    def world_size(self) -> int:
        return math.prod(self.axis_sizes)

    def build(
        self, devices: "Sequence[torch.device | str] | None" = None
    ) -> "MeshContext":
        """The context over ``devices``: ``None`` means the card (raises
        without one); a list holds one device per rank — tests pass
        ``["cpu"] * world_size`` — and this rank takes ``devices[rank]``.
        More than one rank needs the default process group of exactly
        ``world_size`` ranks (``init_distributed``)."""
        if self.pp > 1:
            beside = [f"{n}={getattr(self, n)}" for n in _NOT_WITH_PP
                      if getattr(self, n) > 1]
            if beside:
                raise NotImplementedError(
                    f"pp={self.pp} beside {', '.join(beside)}: pipeline "
                    f"parallelism with context, tensor or expert "
                    f"parallelism is not ported yet (ROADMAP A8.2)")
        rank = 0
        if self.world_size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh of {self.world_size} ranks needs a process "
                    f"group: call init_distributed(rank=..., world_size="
                    f"{self.world_size}, ...) in every process first")
            if dist.get_world_size() != self.world_size:
                raise RuntimeError(
                    f"mesh of {self.world_size} ranks over a process group "
                    f"of {dist.get_world_size()}")
            rank = dist.get_rank()
        if devices is None:
            device = resolve_device(None)
        else:
            devices = list(devices)
            if len(devices) != self.world_size:
                raise ValueError(
                    f"mesh needs {self.world_size} device(s), one per rank, "
                    f"got {len(devices)}")
            device = resolve_device(devices[rank])
        mesh = None
        if self.world_size > 1:
            if device.type == "cuda":
                # NCCL's calls run on the current device
                torch.cuda.set_device(device)
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh(device.type, self.axis_sizes,
                                    mesh_dim_names=MESH_AXIS_NAMES)
        return MeshContext(params=self, device=device, mesh=mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshContext:
    """A built mesh: this rank's device, the ``DeviceMesh`` (``None`` for
    one rank), and the JAX context's axis-group vocabulary."""

    params: MeshParameters
    device: torch.device
    mesh: "object | None" = None  # DeviceMesh

    # --- axis groups (the JAX context's "domains") -----------------------

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return (AXIS_DP_REPLICATE, AXIS_DP_SHARD)

    @property
    def cp_axes(self) -> tuple[str, ...]:
        return (AXIS_CP_SHARD, AXIS_CP_REPLICATE)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Axes over which the global batch dim is split (dp, incl. fsdp)."""
        return self.dp_axes

    @property
    def sequence_axes(self) -> tuple[str, ...]:
        """Axes over which the sequence dim is split (context parallel)."""
        return (AXIS_CP_SHARD,)

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        """Parameter-shard axes: the fused ``dp_s x cp_s`` dim."""
        return (AXIS_DP_SHARD, AXIS_CP_SHARD)

    @property
    def grad_reduce_axes(self) -> tuple[str, ...]:
        """Axes across which gradients of replicated params are summed."""
        return (AXIS_DP_REPLICATE, AXIS_DP_SHARD, AXIS_CP_SHARD,
                AXIS_CP_REPLICATE)

    @functools.cached_property
    def ep_shard_axes(self) -> tuple[str, ...]:
        """Mesh axes forming the expert-shard dim (fastest-varying suffix)."""
        non_pp = list(zip(MESH_AXIS_NAMES[1:], self.params.axis_sizes[1:]))
        return _suffix_axes_covering(self.params.ep_shard, non_pp)

    @functools.cached_property
    def ep_replicate_axes(self) -> tuple[str, ...]:
        """Non-pp axes not part of the expert shard."""
        shard = set(self.ep_shard_axes)
        return tuple(n for n, s in zip(MESH_AXIS_NAMES[1:],
                                       self.params.axis_sizes[1:])
                     if n not in shard)

    # --- sizes, groups and coordinates ----------------------------------

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.params.axis_sizes[MESH_AXIS_NAMES.index(a)]
                         for a in axes)

    @property
    def world_size(self) -> int:
        return self.params.world_size

    @property
    def pp_size(self) -> int:
        return self.params.pp

    @property
    def pp_rank(self) -> int:
        """This rank's ``pp`` coordinate: the pipeline rank whose stages
        it runs."""
        return self.coordinate(AXIS_PP)

    @property
    def cp_size(self) -> int:
        return self.params.cp_shard

    def submesh(self, *axes: str):
        """The ``DeviceMesh`` over ``axes`` (those of size 1 left out, one
        kept if all are), flattened to one dim when there are several;
        ``None`` for a mesh of one rank."""
        if self.mesh is None:
            return None
        axes = tuple(a for a in axes if self.axis_size(a) > 1) or axes[:1]
        cache = self.__dict__.setdefault("_submeshes", {})
        if axes not in cache:
            sub = self.mesh[axes]
            cache[axes] = sub if len(axes) == 1 else sub._flatten(
                "_".join(axes))
        return cache[axes]

    def group(self, *axes: str) -> "dist.ProcessGroup | None":
        """The process group over ``axes`` (a group of one rank where
        their sizes multiply to 1); ``None`` for a mesh of one rank."""
        sub = self.submesh(*axes)
        return None if sub is None else sub.get_group()

    def coordinate(self, *axes: str) -> int:
        """This rank's row-major index over ``axes``."""
        if self.mesh is None:
            return 0
        coord = self.mesh.get_coordinate()
        idx = 0
        for a in axes:
            i = MESH_AXIS_NAMES.index(a)
            idx = idx * self.params.axis_sizes[i] + coord[i]
        return idx

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Axes over which the global batch's rows and positions are cut
        (``batch_axes`` and ``sequence_axes``): a step's sums run over
        them. Ranks along the other axes (``cp_r``, ``tp``) hold the same
        rows and positions, so a sum over those would count them twice."""
        return self.batch_axes + self.sequence_axes

    @property
    def cp_group(self) -> "dist.ProcessGroup | None":
        """The ring's group (``None`` for ``cp_shard = 1``: a ring of one
        rank): the ``cp_s`` ranks at this rank's ``(dp_r, dp_s, cp_r,
        tp)`` coordinate."""
        return self.group(AXIS_CP_SHARD) if self.cp_size > 1 else None

    @property
    def tp_size(self) -> int:
        return self.params.tp

    @property
    def tp_mesh(self):
        """The 1-D ``DeviceMesh`` over ``tp`` at this rank's other
        coordinates (``None`` for ``tp = 1``)."""
        return self.submesh(AXIS_TP) if self.tp_size > 1 else None

    @property
    def tp_group(self) -> "dist.ProcessGroup | None":
        """The tensor-parallel group (``None`` for ``tp = 1``)."""
        return self.group(AXIS_TP) if self.tp_size > 1 else None

    @property
    def tp_rank(self) -> int:
        return self.coordinate(AXIS_TP)

    @property
    def ep_size(self) -> int:
        return self.params.ep_shard

    @property
    def ep_group(self) -> "dist.ProcessGroup | None":
        """The expert-parallel group over ``ep_shard_axes`` (``None`` for
        ``ep_shard = 1``); its group ranks are :attr:`ep_rank`'s order."""
        return self.group(*self.ep_shard_axes) if self.ep_size > 1 else None

    @property
    def ep_rank(self) -> int:
        """This rank's index over ``ep_shard_axes``: it owns experts
        ``[i·E/ep, (i+1)·E/ep)``."""
        return self.coordinate(*self.ep_shard_axes)

    @property
    def ep_replicate_group(self) -> "dist.ProcessGroup | None":
        """The group over ``ep_replicate_axes``: the ranks that hold this
        rank's experts (``None`` for a mesh of one rank)."""
        return self.group(*self.ep_replicate_axes)

    @property
    def cp_rank(self) -> int:
        """Rank ``i`` owns sequence positions ``[i·T/cp, (i+1)·T/cp)``."""
        return self.coordinate(AXIS_CP_SHARD)

    # --- process info ----------------------------------------------------

    @property
    def process_index(self) -> int:
        return dist.get_rank() if self.mesh is not None else 0

    @property
    def process_count(self) -> int:
        return self.world_size

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0
