"""Model-state transformation graph: the mapper abstraction (counterpart
of ``d9d_tpu/model_state/mapper/abc.py``).

The declarative/imperative split of the JAX package:

1. declarative — ``state_dependency_groups()`` announces what will be
   consumed and produced, so the IO layer can plan its streaming, check a
   chain and share work out before it touches a tensor;
2. imperative — ``apply()`` transforms one complete input group.

Tensors are CPU ``torch.Tensor`` s (numpy has no bf16): the IO layer
moves parameters to and from the host around the graph.
"""

import abc
import dataclasses

import torch

StateDict = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StateGroup:
    """Atomic dependency unit: ``inputs`` are all keys required,
    ``outputs`` all keys produced by one independent transformation."""

    inputs: frozenset[str]
    outputs: frozenset[str]


class ModelStateMapper(abc.ABC):
    @abc.abstractmethod
    def state_dependency_groups(self) -> frozenset[StateGroup]:
        """Disjoint dependency groups this mapper handles."""

    @abc.abstractmethod
    def apply(self, group: StateDict) -> StateDict:
        """Transform one group: ``group`` holds exactly one StateGroup's
        inputs, the result exactly its outputs."""
