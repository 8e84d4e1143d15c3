"""Provider protocols wiring user code into the trainer (counterpart of
``d9d_tpu/loop/control/providers.py``).

``ModelProvider.build_module`` receives the mesh context (and, under
pipeline parallelism, the ``stage`` to build) and builds the module ON its
device — the meta device when the trainer's model factory
builds a sharded model (``loop/model_factory.py``), which then
materializes it. ``ModelProvider.build_plan`` names the parallelism plan
(``parallel/plan.py``).
``OptimizerProvider.build`` receives the module's parameters and the
learning rate (a float or a ``step -> lr`` schedule).
"""

import abc
from collections.abc import Callable, Iterable

from torch import nn

from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.optim.adamw import AdamW
from d9d_tpu_torch.parallel.plan import ParallelPlan, replicate_plan
from d9d_tpu_torch.pipelining.stage_info import PipelineStageInfo

WHOLE_MODEL = PipelineStageInfo()


class ModelProvider(abc.ABC):
    @abc.abstractmethod
    def build_module(self, ctx: MeshContext,
                     stage: PipelineStageInfo = WHOLE_MODEL) -> nn.Module:
        """The model, its parameters on ``ctx.device``. Random weights
        come from a seed the module keeps as ``seed`` (the sharded init
        draws from it). ``stage``: the pipeline stage to build (the
        pipeline engine passes it; the default is the whole model, and a
        provider that trains without pipelining may leave the keyword
        out)."""

    def build_plan(self, ctx: MeshContext) -> ParallelPlan:
        """The parallelism plan. Unlike the JAX provider's abstract method
        this has a default, :func:`replicate_plan` (every parameter whole
        on every rank, gradients all-reduced), so providers written before
        the plans existed keep working."""
        return replicate_plan(ctx)


class DatasetProvider(abc.ABC):
    @abc.abstractmethod
    def build(self) -> Iterable[dict]:
        """Yield raw (host) batches of the *global* batch size."""


class OptimizerProvider(abc.ABC):
    @abc.abstractmethod
    def build(self, params, learning_rate: "float | Callable[[int], float]"):
        """An optimizer over ``params`` with a ``count`` and a step: either
        ``step()`` reading each parameter's ``.grad``, cast to the
        parameter's dtype (:class:`d9d_tpu_torch.optim.AdamW`), or, when it
        declares ``accepts_fp32_grads``, ``step(grads)`` taking the fp32
        gradients in the order of ``params`` and owning the parameter
        write (:class:`d9d_tpu_torch.optim.StochasticAdamW`)."""


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
