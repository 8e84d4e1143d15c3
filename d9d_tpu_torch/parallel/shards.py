"""This rank's piece of a parameter that a plan turned into a ``DTensor``
(``parallel/plan.py``: tensor parallelism, ``fully_shard``, or both).

Each cut is ``torch.chunk``'s over the mesh dim that makes it (chunks of
``ceil(n / size)``, the last ones shorter or empty); a mesh dim that
replicates the parameter (HSDP's ``dp_r``) leaves it whole. Cuts of one
dim nest: the ``Shard`` placements in mesh-dim order, outer first, then
the ``_StridedShard`` ones, which FSDP2 gives a dim that tensor
parallelism cut before it (the vocab tables under ``fsdp_plan(with_tp=
True)``: tp is the outer cut, the fsdp axes the inner one, as in the JAX
plan's ``(tp, dp_s, cp_s)``). These helpers name that piece, so that code
which writes a parameter from its whole value (the sharded init, the JAX
weights' loader) writes only the piece, and code that steps on it (the
optimizers) takes the local tensor. A plain tensor is its own piece.
The other way, :func:`gather_whole` puts the pieces together on one
rank (the model-state export).

In a forward, a parameter that tensor parallelism cut is a ``DTensor``
over the 1-D ``tp`` mesh (FSDP has gathered its own cut):
:func:`model_group` names that mesh's group, :func:`vocab_slice` the rows
a vocab-parallel table holds.
"""

import itertools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.placement_types import _StridedShard


def is_sharded(t: torch.Tensor) -> bool:
    """Is ``t`` a ``DTensor`` (a parameter ``fully_shard`` sharded)?"""
    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a ``DTensor`` (under ``no_grad`` it shares the
    parameter's storage, so in-place writes reach the parameter); any
    other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_cuts(t: torch.Tensor) -> list[tuple[int, int]]:
    """``(tensor dim, mesh dim)`` of each cut of ``t``, outer cuts first
    (empty for a plain tensor)."""
    if not isinstance(t, DTensor):
        return []
    plain, strided = [], []
    for mesh_dim, placement in enumerate(t.placements):
        if isinstance(placement, _StridedShard):
            strided.append((placement.dim, mesh_dim))
        elif isinstance(placement, Shard):
            plain.append((placement.dim, mesh_dim))
    return plain + strided


def piece_bounds(t: torch.Tensor,
                 coordinate) -> list[tuple[int, int, int]]:
    """``(dim, start, length)`` of the piece of ``t`` that the rank at
    ``coordinate`` (one index per dim of ``t``'s device mesh) holds, along
    each sharded dim, in the whole tensor's coordinates."""
    bounds = {}
    for d, mesh_dim in shard_cuts(t):
        lo, n = bounds.get(d, (0, t.shape[d]))
        size, r = t.device_mesh.size(mesh_dim), int(coordinate[mesh_dim])
        chunk = -(-n // size)
        start = min(r * chunk, n)
        bounds[d] = (lo + start, max(0, min(chunk, n - start)))
    return [(d, lo, n) for d, (lo, n) in sorted(bounds.items())]


def shard_bounds(t: torch.Tensor) -> list[tuple[int, int, int]]:
    """``(dim, start, length)`` of this rank's piece along each sharded dim
    of ``t``, in the whole tensor's coordinates (empty for a whole
    tensor)."""
    if not isinstance(t, DTensor):
        return []
    return piece_bounds(t, t.device_mesh.get_coordinate())


def local_piece(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The piece of ``whole`` (the full value of ``like``) that this rank
    holds of ``like``."""
    for d, start, n in shard_bounds(like):
        whole = whole.narrow(d, start, n)
    return whole


def like_param(local: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``local`` (a tensor shaped as this rank's piece of ``param``, such
    as an optimizer moment) laid out as ``param`` is: a ``DTensor`` over
    ``param``'s mesh and placements with its global shape and stride,
    sharing ``local``'s storage (no communication); ``local`` itself for a
    plain ``param``. A checkpoint of it holds each rank's piece where it
    lies in the whole tensor, so it loads in place onto any mesh."""
    if not isinstance(param, DTensor):
        return local
    return DTensor.from_local(local, param.device_mesh, param.placements,
                              run_check=False, shape=param.shape,
                              stride=param.stride())


def write_whole_(param: torch.Tensor, whole: torch.Tensor) -> None:
    """Write the full value ``whole`` into ``param``: all of it into a
    plain tensor, this rank's piece into a ``DTensor``."""
    with torch.no_grad():
        local_tensor(param).copy_(local_piece(whole, param))


def gather_whole(t: torch.Tensor, dst: int = 0) -> "torch.Tensor | None":
    """The whole value of ``t`` on the CPU of global rank ``dst``, ``None``
    on the other ranks (collective over the ranks of ``t``'s device mesh
    that holds ``dst``; the meshes of the other ranks hold copies of the
    same pieces and do nothing). Each distinct piece (:func:`piece_bounds`:
    uneven chunks, nested and strided cuts) is sent once, by the lowest
    rank holding it, point to point, so only ``dst`` ever holds the whole
    tensor. Pieces travel where the default group's backend takes them:
    the CPU for gloo, the card for NCCL. A plain tensor is whole on every
    rank: ``dst`` returns its copy."""
    me = dist.get_rank() if dist.is_initialized() else dst
    if not isinstance(t, DTensor):
        return t.detach().to("cpu", copy=True) if me == dst else None
    ranks = t.device_mesh.mesh
    if not bool((ranks == dst).any()):
        return None
    holder: dict[tuple, int] = {}
    for coord in sorted(itertools.product(*map(range, ranks.shape)),
                        key=lambda c: int(ranks[c])):
        key = tuple(piece_bounds(t, coord))
        rank = int(ranks[coord])
        if rank == dst or key not in holder:
            holder[key] = rank
    place = (torch.device("cuda", torch.cuda.current_device())
             if dist.get_backend() == dist.Backend.NCCL else
             torch.device("cpu"))
    local = t.to_local().detach()
    if me != dst:
        if me in holder.values() and local.numel():
            dist.send(local.to(place).contiguous(), dst)
        return None
    whole = torch.empty(t.shape, dtype=t.dtype)
    for key, rank in holder.items():
        if rank == me:
            piece = local
        else:
            piece = torch.empty(_piece_shape(t.shape, key), dtype=t.dtype,
                                device=place)
            if piece.numel():
                dist.recv(piece, rank)
        view = whole
        for d, start, n in key:
            view = view.narrow(d, start, n)
        view.copy_(piece.reshape(view.shape))
    return whole


def _piece_shape(shape, bounds) -> list[int]:
    out = list(shape)
    for d, _, n in bounds:
        out[d] = n
    return out


def vocab_slice(weight: torch.Tensor):
    """``(local rows, first row, group)`` of a vocab table in a forward:
    for a ``DTensor`` that tensor parallelism cut on dim 0 over a 1-D mesh,
    this rank's rows (differentiable: their gradient is the table's piece),
    their first index in the whole table and the mesh's group; for any
    other tensor ``(weight, 0, None)``."""
    if not isinstance(weight, DTensor):
        return weight, 0, None
    mesh = weight.device_mesh
    bounds = shard_bounds(weight)
    if mesh.ndim != 1 or [b[0] for b in bounds] != [0]:
        raise ValueError(
            f"a vocab table in a forward must be cut on its vocab dim over "
            f"one mesh dim, got {weight.placements} over {mesh}")
    return weight.to_local(), bounds[0][1], mesh.get_group(0)


def model_group(weight: torch.Tensor):
    """The group of the 1-D mesh a parameter in a forward is cut over
    (``None`` for a plain tensor: no tensor parallelism)."""
    if not isinstance(weight, DTensor):
        return None
    return weight.device_mesh.get_group(0)


__all__ = ["gather_whole", "is_sharded", "like_param", "local_piece",
           "local_tensor",
           "model_group", "piece_bounds", "shard_bounds", "shard_cuts",
           "vocab_slice", "write_whole_"]
