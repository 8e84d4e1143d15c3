"""A model's parameters ⇄ a checkpoint (counterpart of
``d9d_tpu/model_state/io/module.py``).

- Save: one parameter at a time, each sharded parameter (``fully_shard``,
  tensor parallelism's block and strided cuts, experts cut over the ep
  sub-mesh) is put together whole on the writing rank alone
  (``parallel/shards.py`` ``gather_whole``: the experts over their ep
  group, every distinct piece sent once), then streamed through the
  mapper into safetensors files. On a mesh every rank takes part and one
  writes.
- Load: with the identity mapper each rank reads just the rows of its
  piece of each parameter (its dim-0 cut; other cuts are taken from those
  rows) and writes its piece; through another mapper each output arrives
  whole and each rank writes its piece (``write_whole_``), as
  ``model_state/from_jax.py`` ``load_jax_params`` does.

``params`` is a module (its ``named_parameters()``) or a mapping of names
to tensors. Errors are the JAX package's: an output the model lacks, a
shape that differs, a parameter the checkpoint lacks.
"""

from collections import defaultdict
from collections.abc import Iterable, Mapping
from pathlib import Path

import torch
import torch.distributed as dist
from torch import nn

from d9d_tpu_torch.model_state.io.reader import read_index, read_model_state
from d9d_tpu_torch.model_state.io.safetensors_format import SafetensorsFile
from d9d_tpu_torch.model_state.io.writer import (
    write_model_state_distributed,
    write_model_state_local,
    write_model_state_pipeline_parallel,
)
from d9d_tpu_torch.model_state.mapper.abc import (
    ModelStateMapper,
    StateDict,
    StateGroup,
)
from d9d_tpu_torch.model_state.mapper.compose import ModelStateMapperParallel
from d9d_tpu_torch.model_state.mapper.leaf import ModelStateMapperIdentity
from d9d_tpu_torch.parallel.shards import (
    gather_whole,
    local_tensor,
    shard_bounds,
    write_whole_,
)


def named_params(params) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, Mapping):
        return dict(params)
    raise TypeError(f"params must be a module or a mapping, got "
                    f"{type(params).__name__}")


def identity_mapper_from_names(names: Iterable[str]) -> ModelStateMapper:
    """Mapper that passes every named state through unchanged."""
    return ModelStateMapperParallel(
        [ModelStateMapperIdentity(n) for n in names])


def identity_mapper_from_params(params) -> ModelStateMapper:
    return identity_mapper_from_names(named_params(params))


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def param_state_generator(
    params,
) -> Iterable[tuple[str, "torch.Tensor | None"]]:
    """Stream ``(name, whole CPU tensor)`` pairs, one parameter whole at a
    time; on a mesh, collective, and ranks other than 0 get
    ``(name, None)``."""
    for name, p in named_params(params).items():
        yield name, gather_whole(p)


def save_params(
    dest_dir: Path,
    params,
    mapper: ModelStateMapper | None = None,
    shard_size_gb: float = 4.0,
) -> None:
    """Save parameters through ``mapper`` into sharded safetensors (on a
    mesh: collective, rank 0 writes)."""
    named = named_params(params)
    if mapper is None:
        mapper = identity_mapper_from_names(named)
    if _distributed():
        write_model_state_distributed(dest_dir, mapper,
                                      param_state_generator(named),
                                      shard_size_gb=shard_size_gb)
    else:
        write_model_state_local(dest_dir, mapper,
                                param_state_generator(named),
                                shard_size_gb=shard_size_gb)


class _StageMapper(ModelStateMapper):
    """The groups of ``mapper`` whose inputs are all in ``names``."""

    def __init__(self, mapper: ModelStateMapper, names):
        self._mapper = mapper
        names = set(names)
        self._groups = frozenset(g for g in mapper.state_dependency_groups()
                                 if g.inputs <= names)

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return self._groups

    def apply(self, group: StateDict) -> StateDict:
        return self._mapper.apply(group)


def save_params_pipeline_parallel(
    dest_dir: Path,
    params,
    mapper: ModelStateMapper | None = None,
    *,
    writer_rank: int,
    writer: int,
    shard_size_gb: float = 4.0,
) -> None:
    """Save the parameters of this rank's pipeline stages (collective over
    every rank): each stage group's writer (global rank ``writer``, one
    rank per ``pp`` coordinate; ``writer_rank`` its pp rank) puts each
    parameter together whole (``gather_whole`` over the stage's ranks that
    cut it) and streams its stages' parameters through the groups of
    ``mapper`` whose inputs they hold; one index merges the files. Every
    group of ``mapper`` must lie within one rank's stages (checked: the
    writers' groups must add up to all of them)."""
    from d9d_tpu_torch.core.collectives import host_allgather_object

    named = named_params(params)
    is_local_writer = dist.get_rank() == writer
    local = _StageMapper(mapper if mapper is not None
                         else identity_mapper_from_names(named), named)
    covered = host_allgather_object(
        (writer_rank, sorted(tuple(sorted(g.inputs))
                             for g in local.state_dependency_groups()))
        if is_local_writer else None)
    if mapper is not None:
        groups = {g for item in covered if item is not None
                  for g in item[1]}
        want = {tuple(sorted(g.inputs))
                for g in mapper.state_dependency_groups()}
        if groups != want:
            raise ValueError(
                f"mapper groups that no pipeline stage holds whole: "
                f"{sorted(want - groups)[:4]}")
    states = ((n, gather_whole(p, dst=writer)) for n, p in named.items())
    write_model_state_pipeline_parallel(
        dest_dir, local, states, writer_rank=writer_rank,
        is_local_writer=is_local_writer, shard_size_gb=shard_size_gb)


def _check_shape(name: str, got, want: torch.Tensor) -> None:
    if tuple(got) != tuple(want.shape):
        raise ValueError(f"shape mismatch for {name}: checkpoint "
                         f"{tuple(got)} vs template {tuple(want.shape)}")


def read_piece(st: SafetensorsFile, name: str,
               like: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``name`` in ``st`` for the parameter ``like``
    (whole for a plain tensor): only the rows of its dim-0 cut are read,
    its other cuts are taken from them."""
    _check_shape(name, st.shape(name), like)
    if not like.shape:
        return st.get_tensor(name)
    bounds = shard_bounds(like)
    lo, n = next(((s, n) for d, s, n in bounds if d == 0),
                 (0, like.shape[0]))
    piece = st.get_rows(name, lo, lo + n)
    for d, start, n in bounds:
        if d:
            piece = piece.narrow(d, start, n)
    return piece


def _read_pieces(src_dir: Path, named: dict) -> None:
    """The identity load: each parameter's piece from the rows it needs."""
    index = read_index(src_dir)
    missing = set(named).difference(index.weight_map)
    if missing:
        raise ValueError(f"Cannot run state loading: states "
                         f"{sorted(missing)} are missing!")
    by_file = defaultdict(list)
    for name in named:
        by_file[index.weight_map[name]].append(name)
    for fname, names in by_file.items():
        with SafetensorsFile(Path(src_dir) / fname) as st:
            for name in sorted(names):
                piece = read_piece(st, name, named[name])
                with torch.no_grad():
                    local_tensor(named[name]).copy_(piece)


def load_params(
    src_dir: Path,
    params,
    mapper: ModelStateMapper | None = None,
) -> None:
    """Fill ``params`` (a module or a mapping of its tensors) in place from
    a checkpoint, each rank its own piece of every parameter, cast to the
    parameter's dtype."""
    named = named_params(params)
    meta = sorted(n for n, p in named.items() if p.is_meta)
    if meta:
        raise ValueError(f"load_params: parameters on the meta device "
                         f"({meta[:3]}...): load after the model is "
                         f"materialized")
    if mapper is None:
        _read_pieces(src_dir, named)
        return
    loaded: set[str] = set()
    for name, value in read_model_state(src_dir, mapper):
        if name not in named:
            raise KeyError(f"checkpoint produced unknown param {name!r}; "
                           f"template has {len(named)} params")
        _check_shape(name, value.shape, named[name])
        write_whole_(named[name], value)
        loaded.add(name)
    missing = set(named) - loaded
    if missing:
        raise ValueError(f"checkpoint missing params: {sorted(missing)[:10]}"
                         f"{'...' if len(missing) > 10 else ''}")


__all__ = ["identity_mapper_from_names", "identity_mapper_from_params",
           "load_params", "named_params", "param_state_generator",
           "read_piece", "save_params", "save_params_pipeline_parallel"]
