"""User-facing task protocol (counterpart of
``d9d_tpu/loop/control/task.py`` ``TrainTask``).

The user supplies (1) host-side batch preparation and (2) the
per-microbatch loss. The weighted-loss contract is the JAX package's:
``loss_fn`` returns ``(loss_sum, weight, metrics)`` and the engine divides
the summed gradients by the global ``Σ weight`` after accumulation —
sum-then-scale, not mean-of-means. Where the JAX ``loss_fn`` is pure over a
parameter tree, the port's takes the module, which holds its parameters.
"""

import abc
from typing import Any

import torch
from torch import nn


class TrainTask(abc.ABC):
    """Defines what is being optimized, independent of where it runs."""

    @abc.abstractmethod
    def prepare_batch(self, batch: dict) -> dict:
        """Host-side: raw loader batch → dict of arrays (numpy is fine).
        The leading dim is the global batch; the engine splits it into
        microbatches and moves them to the device."""

    @abc.abstractmethod
    def loss_fn(
        self, module: nn.Module, microbatch: dict[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
        """→ ``(loss_sum, weight, metrics)``, device scalars: the SUM of
        per-example losses of this microbatch, its total weight (e.g. the
        unmasked token count), and raw statistics the engine sums over
        microbatches."""

    def metrics_postprocess(self, metrics: dict[str, Any]) -> dict[str, Any]:
        """Optional host-side metric transformation before logging."""
        return metrics

    def metrics(self) -> dict[str, Any]:
        """Metric objects this task maintains (none by default); see
        ``loop/components/metric_collector.py``."""
        return {}

    def update_metrics(self, metric_objs: dict[str, Any],
                       stats: dict[str, Any]) -> None:
        """Feed windowed host statistics into ``metrics()`` objects."""
