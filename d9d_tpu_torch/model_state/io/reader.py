"""Streaming checkpoint reader (counterpart of
``d9d_tpu/model_state/io/reader.py``): plan which keys to take from which
safetensors file from the mapper's dependency groups, open each file once,
fire a mapper group as soon as its inputs are read and drop them at once.
Memory holds one group and one file's keys, never the whole checkpoint.
"""

from collections import defaultdict
from collections.abc import Generator, Iterable
from pathlib import Path

import torch

from d9d_tpu_torch.model_state.io.dto import (
    MODEL_STATE_INDEX_FILE_NAME,
    ModelStateIndex,
    ModelStateIndexMeta,
)
from d9d_tpu_torch.model_state.io.safetensors_format import SafetensorsFile
from d9d_tpu_torch.model_state.mapper.abc import ModelStateMapper


def read_index(src_dir: Path) -> ModelStateIndex:
    """The checkpoint's index; a lone ``model.safetensors`` gets one
    made up."""
    src_dir = Path(src_dir)
    index_file = src_dir / MODEL_STATE_INDEX_FILE_NAME
    if not index_file.exists():
        single = src_dir / "model.safetensors"
        if single.exists():
            with SafetensorsFile(single) as st:
                keys = st.keys()
            return ModelStateIndex(
                metadata=ModelStateIndexMeta(total_size=0),
                weight_map={k: "model.safetensors" for k in keys})
        raise FileNotFoundError(index_file)
    return ModelStateIndex.from_json(index_file.read_text(encoding="utf-8"))


class _StateLoadingFlow:
    def __init__(self, src_dir: Path, mapper: ModelStateMapper):
        self._src_dir = Path(src_dir)
        self._mapper = mapper
        self._index = read_index(self._src_dir)
        self._groups_to_process = set(mapper.state_dependency_groups())
        self._stored_states: dict[str, torch.Tensor] = {}
        required: set[str] = set()
        for group in self._groups_to_process:
            required.update(group.inputs)
        missing = required.difference(self._index.weight_map)
        if missing:
            raise ValueError(
                f"Cannot run state loading: states {sorted(missing)} are "
                f"missing!")

    def _process_available_groups(
        self,
    ) -> Generator[tuple[str, torch.Tensor], None, None]:
        for group in self._groups_to_process.copy():
            if not group.inputs.issubset(self._stored_states.keys()):
                continue
            self._groups_to_process.remove(group)
            outputs = self._mapper.apply(
                {k: self._stored_states[k] for k in group.inputs})
            yield from outputs.items()
            for input_name in group.inputs:
                del self._stored_states[input_name]

    def _build_file_loading_plan(self) -> dict[str, set[str]]:
        plan: dict[str, set[str]] = defaultdict(set)
        for group in self._mapper.state_dependency_groups():
            for key in group.inputs:
                plan[self._index.weight_map[key]].add(key)
        return plan

    def load(self) -> Iterable[tuple[str, torch.Tensor]]:
        for file_name, keys in self._build_file_loading_plan().items():
            with SafetensorsFile(self._src_dir / file_name) as st:
                for key in sorted(keys):
                    self._stored_states[key] = st.get_tensor(key)
            yield from self._process_available_groups()
        if self._groups_to_process:
            missing = {g.inputs for g in self._groups_to_process}
            raise ValueError(
                f"Reading finished with unsatisfied groups: {missing}")


def read_model_state(
    src_dir: Path, mapper: ModelStateMapper
) -> Iterable[tuple[str, torch.Tensor]]:
    """Stream ``(name, CPU tensor)`` pairs from a checkpoint, transformed
    by ``mapper``."""
    yield from _StateLoadingFlow(src_dir=src_dir, mapper=mapper).load()


__all__ = ["read_index", "read_model_state"]
