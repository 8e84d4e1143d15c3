"""This rank's piece of a parameter that ``fully_shard`` turned into a
``DTensor``.

FSDP2 cuts a parameter's shard dim as ``torch.chunk`` does over each mesh
dim that shards it (chunks of ``ceil(n / size)``, the last ones shorter or
empty) and keeps the rest whole; a mesh dim that replicates it (HSDP's
``dp_r``) leaves it whole. These helpers name that piece, so that code
which writes a parameter from its whole value (the sharded init, the JAX
weights' loader) writes only the piece, and code that steps on it (the
optimizers) takes the local tensor. A plain tensor is its own piece.
"""

import torch
from torch.distributed.tensor import DTensor, Shard


def is_sharded(t: torch.Tensor) -> bool:
    """Is ``t`` a ``DTensor`` (a parameter ``fully_shard`` sharded)?"""
    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a ``DTensor`` (under ``no_grad`` it shares the
    parameter's storage, so in-place writes reach the parameter); any
    other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_bounds(t: torch.Tensor) -> list[tuple[int, int, int]]:
    """``(dim, start, length)`` of this rank's piece along each sharded dim
    of ``t``, in the whole tensor's coordinates (empty for a whole
    tensor)."""
    if not isinstance(t, DTensor):
        return []
    bounds = {}
    mesh = t.device_mesh
    for mesh_dim, placement in enumerate(t.placements):
        if not isinstance(placement, Shard):
            continue
        d = placement.dim
        lo, n = bounds.get(d, (0, t.shape[d]))
        size, r = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
        chunk = -(-n // size)
        start = min(r * chunk, n)
        bounds[d] = (lo + start, max(0, min(chunk, n - start)))
    return [(d, lo, n) for d, (lo, n) in sorted(bounds.items())]


def local_piece(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The piece of ``whole`` (the full value of ``like``) that this rank
    holds of ``like``."""
    for d, start, n in shard_bounds(like):
        whole = whole.narrow(d, start, n)
    return whole


def write_whole_(param: torch.Tensor, whole: torch.Tensor) -> None:
    """Write the full value ``whole`` into ``param``: all of it into a
    plain tensor, this rank's piece into a ``DTensor``."""
    with torch.no_grad():
        local_tensor(param).copy_(local_piece(whole, param))


__all__ = ["is_sharded", "local_piece", "local_tensor", "shard_bounds",
           "write_whole_"]
