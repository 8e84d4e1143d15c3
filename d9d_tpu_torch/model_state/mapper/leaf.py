"""Leaf mappers: one-tensor and several-tensor primitives (counterpart of
``d9d_tpu/model_state/mapper/leaf.py``), on CPU ``torch.Tensor`` s.

Distribution and gathering are not leaves here either: the module IO
layer (``model_state/io/module.py``) gathers a sharded parameter whole
before the graph and writes each rank's piece after it.
"""

import torch

from d9d_tpu_torch.model_state.mapper.abc import (
    ModelStateMapper,
    StateDict,
    StateGroup,
)


def _single(name_in: str, name_out: str) -> frozenset[StateGroup]:
    return frozenset([StateGroup(inputs=frozenset([name_in]),
                                 outputs=frozenset([name_out]))])


def _many_to_one(sources, target) -> frozenset[StateGroup]:
    return frozenset([StateGroup(inputs=frozenset(sources),
                                 outputs=frozenset([target]))])


def _one_to_many(source, targets) -> frozenset[StateGroup]:
    return frozenset([StateGroup(inputs=frozenset([source]),
                                 outputs=frozenset(targets))])


class ModelStateMapperIdentity(ModelStateMapper):
    """Pass one tensor through unchanged."""

    def __init__(self, name: str):
        self._name = name

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name, self._name)

    def apply(self, group: StateDict) -> StateDict:
        return group


class ModelStateMapperRename(ModelStateMapper):
    def __init__(self, name_from: str, name_to: str):
        self._name_from = name_from
        self._name_to = name_to

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name_from, self._name_to)

    def apply(self, group: StateDict) -> StateDict:
        return {self._name_to: group[self._name_from]}


class ModelStateMapperTranspose(ModelStateMapper):
    def __init__(self, name: str, dims: tuple[int, int]):
        self._name = name
        self._dims = dims

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name, self._name)

    def apply(self, group: StateDict) -> StateDict:
        return {self._name: group[self._name].transpose(*self._dims)}


class ModelStateMapperSqueeze(ModelStateMapper):
    """Drop a dim of size 1 (``dim=None``: every such dim); a ``dim`` of
    another size raises, as numpy's ``squeeze`` does."""

    def __init__(self, name: str, dim: int | None = None):
        self._name = name
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name, self._name)

    def apply(self, group: StateDict) -> StateDict:
        t = group[self._name]
        if self._dim is None:
            return {self._name: t.squeeze()}
        if t.shape[self._dim] != 1:
            raise ValueError(f"cannot squeeze dim {self._dim} of size "
                             f"{t.shape[self._dim]} of {self._name}")
        return {self._name: t.squeeze(self._dim)}


class ModelStateMapperUnsqueeze(ModelStateMapper):
    def __init__(self, name: str, dim: int):
        self._name = name
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name, self._name)

    def apply(self, group: StateDict) -> StateDict:
        return {self._name: group[self._name].unsqueeze(self._dim)}


class ModelStateMapperCast(ModelStateMapper):
    """Cast one tensor to ``dtype`` (a ``torch.dtype``)."""

    def __init__(self, name: str, dtype: torch.dtype):
        self._name = name
        self._dtype = dtype

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _single(self._name, self._name)

    def apply(self, group: StateDict) -> StateDict:
        return {self._name: group[self._name].to(self._dtype)}


class ModelStateMapperStackTensors(ModelStateMapper):
    """Stack inputs into one output along a new dim."""

    def __init__(self, source_names: list[str], target_name: str, dim: int):
        self._source_names = list(source_names)
        self._target_name = target_name
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _many_to_one(self._source_names, self._target_name)

    def apply(self, group: StateDict) -> StateDict:
        return {self._target_name: torch.stack(
            [group[n] for n in self._source_names], dim=self._dim)}


class ModelStateMapperUnstackTensors(ModelStateMapper):
    def __init__(self, source_name: str, target_names: list[str], dim: int):
        self._source_name = source_name
        self._target_names = list(target_names)
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_to_many(self._source_name, self._target_names)

    def apply(self, group: StateDict) -> StateDict:
        tensor = group[self._source_name]
        if tensor.shape[self._dim] != len(self._target_names):
            raise ValueError(
                f"cannot unstack dim of size {tensor.shape[self._dim]} into "
                f"{len(self._target_names)} tensors")
        parts = tensor.unbind(self._dim)
        return {name: parts[i].contiguous()
                for i, name in enumerate(self._target_names)}


class ModelStateMapperChunkTensors(ModelStateMapper):
    """Split one tensor into ``len(target_names)`` chunks along ``dim``,
    numpy's ``array_split`` sizes (the first ``n % k`` one longer)."""

    def __init__(self, source_name: str, target_names: list[str], dim: int):
        self._source_name = source_name
        self._target_names = list(target_names)
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_to_many(self._source_name, self._target_names)

    def apply(self, group: StateDict) -> StateDict:
        chunks = torch.tensor_split(group[self._source_name],
                                    len(self._target_names), dim=self._dim)
        return {name: chunk.contiguous()
                for name, chunk in zip(self._target_names, chunks,
                                       strict=True)}


class ModelStateMapperConcatenateTensors(ModelStateMapper):
    def __init__(self, source_names: list[str], target_name: str, dim: int):
        self._source_names = list(source_names)
        self._target_name = target_name
        self._dim = dim

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _many_to_one(self._source_names, self._target_name)

    def apply(self, group: StateDict) -> StateDict:
        return {self._target_name: torch.cat(
            [group[n] for n in self._source_names], dim=self._dim)}


class ModelStateMapperSelectChildModules(ModelStateMapper):
    """Hoist keys out of a parent scope: ``parent.x -> x``, one group a
    key."""

    def __init__(self, base_names: list[str], parent_name: str):
        self._base_names = list(base_names)
        self._parent_prefix = f"{parent_name}."

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return frozenset(
            StateGroup(inputs=frozenset([self._parent_prefix + name]),
                       outputs=frozenset([name]))
            for name in self._base_names)

    def apply(self, group: StateDict) -> StateDict:
        name, value = next(iter(group.items()))
        if name.startswith(self._parent_prefix):
            return {name[len(self._parent_prefix):]: value}
        return {}
