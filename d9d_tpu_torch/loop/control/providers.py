"""Provider protocols wiring user code into the trainer (counterpart of
``d9d_tpu/loop/control/providers.py``).

``ModelProvider.build_module`` receives the mesh context and builds the
module ON its device (the JAX provider builds an unbound flax module and a
parallelism plan; a one-device port has no plan to build).
``OptimizerProvider.build`` receives the module's parameters and the
learning rate (a float or a ``step -> lr`` schedule).
"""

import abc
from collections.abc import Callable, Iterable

from torch import nn

from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.optim.adamw import AdamW


class ModelProvider(abc.ABC):
    @abc.abstractmethod
    def build_module(self, ctx: MeshContext) -> nn.Module:
        """The model, its parameters on ``ctx.device``."""


class DatasetProvider(abc.ABC):
    @abc.abstractmethod
    def build(self) -> Iterable[dict]:
        """Yield raw (host) batches of the *global* batch size."""


class OptimizerProvider(abc.ABC):
    @abc.abstractmethod
    def build(self, params, learning_rate: "float | Callable[[int], float]"):
        """An optimizer over ``params`` with the ``step()`` / ``count``
        surface of :class:`d9d_tpu_torch.optim.AdamW`."""


class AdamWProvider(OptimizerProvider):
    """optax ``adamw`` semantics (see ``optim/adamw.py``); b2 = 0.95 by
    default, as in the JAX provider. Weight decay applies to every
    parameter: the JAX provider passes no mask."""

    def __init__(self, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def build(self, params, learning_rate) -> AdamW:
        return AdamW(params, learning_rate, b1=self.b1, b2=self.b2,
                     eps=self.eps, weight_decay=self.weight_decay)
