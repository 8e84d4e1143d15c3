"""Streaming checkpoint writer (counterpart of
``d9d_tpu/model_state/io/writer.py``): consume a ``(name, tensor)``
stream, fire mapper groups as their inputs complete, spill safetensors
files of at most ``shard_size_gb`` and publish one HF-compatible index.

``_ShardSpool`` owns the size-capped spilling to ``.spool-{tag}-N``
files, ``_GroupStream`` the firing of groups (an arriving key is matched
through a key → groups index), and ``_publish`` renames the spooled files
into the final ``model-XXXXX-of-YYYYY.safetensors`` numbering and writes
``model.safetensors.index.json``. Two modes: local (one process) and
distributed (every rank streams the names, one rank holds the tensors and
writes) and pipeline-parallel (each stage group writes its own states,
one index merges them).
"""

import warnings
from collections.abc import Callable, Iterable
from pathlib import Path

import torch
import torch.distributed as dist

from d9d_tpu_torch.model_state.io.dto import (
    MODEL_STATE_INDEX_FILE_NAME,
    ModelStateIndex,
    ModelStateIndexMeta,
)
from d9d_tpu_torch.model_state.io.safetensors_format import save_file
from d9d_tpu_torch.model_state.mapper.abc import ModelStateMapper


class _ShardSpool:
    """Size-capped safetensors spooler writing ``.spool-{tag}-N`` files."""

    def __init__(self, dest_dir: Path, cap_bytes: int, tag: str):
        self._dir = Path(dest_dir)
        self._cap = cap_bytes
        self._tag = tag
        self._buffer: dict[str, torch.Tensor] = {}
        self._buffered = 0
        self._spilled_files: list[str] = []
        self._locations: dict[str, str] = {}  # weight name → temp file name
        self._bytes_total = 0

    def add(self, name: str, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        if nbytes > self._cap:
            raise ValueError(
                f"tensor {name!r} is {nbytes} bytes — larger than the shard "
                f"size cap ({self._cap}); raise shard_size_gb")
        if self._buffered + nbytes > self._cap:
            self._spill()
        self._buffer[name] = t
        self._buffered += nbytes

    def _spill(self) -> None:
        if not self._buffer:
            return
        fname = f".spool-{self._tag}-{len(self._spilled_files)}.safetensors"
        save_file(self._buffer, self._dir / fname)
        self._spilled_files.append(fname)
        self._locations.update({k: fname for k in self._buffer})
        self._bytes_total += self._buffered
        self._buffer.clear()
        self._buffered = 0

    def finish(self) -> ModelStateIndex:
        self._spill()
        return ModelStateIndex(
            metadata=ModelStateIndexMeta(total_size=self._bytes_total),
            weight_map=dict(self._locations))


class _GroupStream:
    """Mapper groups fired over a stream of named tensors. With
    ``compute=False`` the stream only tracks which groups complete (a rank
    that streams the names and holds no tensor)."""

    def __init__(self, mapper: ModelStateMapper,
                 emit: Callable[[str, torch.Tensor], None],
                 compute: bool = True):
        self._mapper = mapper
        self._emit = emit
        self._compute = compute
        self._inbox: dict[str, torch.Tensor | None] = {}
        self._open: set = set(mapper.state_dependency_groups())
        self._by_key: dict[str, list] = {}
        for group in self._open:
            for key in group.inputs:
                self._by_key.setdefault(key, []).append(group)

    def push(self, name: str, t: "torch.Tensor | None") -> None:
        self._inbox[name] = t
        for group in self._by_key.get(name, ()):
            if group not in self._open:
                continue
            if not group.inputs <= self._inbox.keys():
                continue
            self._open.discard(group)
            produced = (self._mapper.apply(
                {k: self._inbox[k] for k in group.inputs})
                if self._compute else {})
            for key in group.inputs:
                # a key feeds exactly one group (the mapper contract), so it
                # is dead once that group fired
                del self._inbox[key]
            for out_name, out in produced.items():
                self._emit(out_name, out)

    def finish(self) -> None:
        if self._open:
            unfired = sorted(tuple(sorted(g.inputs)) for g in self._open)
            raise ValueError(
                "state stream ended with dependency groups still waiting "
                f"for inputs: {unfired}")
        if self._inbox:
            warnings.warn(
                "state stream carried tensors no mapper group consumes: "
                f"{sorted(self._inbox)}", stacklevel=2)


def _run_stream(dest_dir: Path, mapper: ModelStateMapper,
                states: Iterable[tuple[str, "torch.Tensor | None"]],
                shard_size_gb: float, tag: str,
                writes: bool) -> ModelStateIndex | None:
    """Drive the stream; spool to disk only when ``writes`` (the other
    ranks still check that every group completes)."""
    dest_dir = Path(dest_dir)
    if writes:
        dest_dir.mkdir(parents=True, exist_ok=True)
    spool = (_ShardSpool(dest_dir, int(shard_size_gb * (1024 ** 3)), tag)
             if writes else None)
    sink = spool.add if spool is not None else (lambda name, t: None)
    stream = _GroupStream(mapper, sink, compute=writes)
    for name, t in states:
        stream.push(name, t)
    stream.finish()
    return spool.finish() if spool is not None else None


def _publish(dest_dir: Path, spooled: list[ModelStateIndex]) -> None:
    """Rename the spool files into the global shard numbering and write
    the index."""
    dest_dir = Path(dest_dir)
    temp_files: list[str] = []
    for index in spooled:
        for fname in index.weight_map.values():
            if fname not in temp_files:
                temp_files.append(fname)
    renamed = {old: f"model-{i + 1:05d}-of-{len(temp_files):05d}.safetensors"
               for i, old in enumerate(temp_files)}
    for old, new in renamed.items():
        (dest_dir / old).rename(dest_dir / new)
    merged = ModelStateIndex(
        metadata=ModelStateIndexMeta(
            total_size=sum(ix.metadata.total_size for ix in spooled)),
        weight_map={name: renamed[fname] for ix in spooled
                    for name, fname in ix.weight_map.items()})
    (dest_dir / MODEL_STATE_INDEX_FILE_NAME).write_text(
        merged.to_json(indent=4), encoding="utf-8")


def write_model_state_local(
    dest_dir: Path,
    mapper: ModelStateMapper,
    state_generator: Iterable[tuple[str, torch.Tensor]],
    shard_size_gb: float = 4.0,
) -> None:
    """Single-process save."""
    index = _run_stream(dest_dir, mapper, state_generator, shard_size_gb,
                        tag="0", writes=True)
    _publish(dest_dir, [index])


def write_model_state_distributed(
    dest_dir: Path,
    mapper: ModelStateMapper,
    state_generator: Iterable[tuple[str, "torch.Tensor | None"]],
    shard_size_gb: float = 4.0,
) -> None:
    """Every rank streams the same names; rank 0 holds the tensors and
    writes, the others may yield ``None`` for them. Collective: no rank
    returns before the index is written."""
    writes = dist.get_rank() == 0
    index = _run_stream(dest_dir, mapper, state_generator, shard_size_gb,
                        tag="0", writes=writes)
    if writes:
        _publish(dest_dir, [index])
    # no rank may look at the directory before the writer renamed the
    # shards and wrote the index
    dist.barrier()


def write_model_state_pipeline_parallel(
    dest_dir: Path,
    mapper: ModelStateMapper,
    state_generator: Iterable[tuple[str, "torch.Tensor | None"]],
    writer_rank: int,
    is_local_writer: bool,
    shard_size_gb: float = 4.0,
) -> None:
    """Each pipeline stage group writes its own states; the indices are
    merged (the JAX package's third mode). ``mapper`` covers the stage
    group's states; ``is_local_writer`` selects one process per stage
    group (the others stream the names with ``None``); ``writer_rank``
    must be unique among writers (the pp rank) so the spool names do not
    collide. Collective: no rank returns before the index is written."""
    from d9d_tpu_torch.core.collectives import host_allgather_object

    index = _run_stream(dest_dir, mapper, state_generator, shard_size_gb,
                        tag=str(writer_rank), writes=is_local_writer)
    spooled = [ix for ix in host_allgather_object(index) if ix is not None]
    mesh = dist.is_initialized()
    if not mesh or dist.get_rank() == 0:
        _publish(dest_dir, spooled)
    if mesh:
        dist.barrier()


__all__ = ["write_model_state_distributed", "write_model_state_local",
           "write_model_state_pipeline_parallel"]
