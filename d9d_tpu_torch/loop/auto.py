"""Config-driven optimizer and LR-schedule factories (counterpart of
``d9d_tpu/loop/auto.py``), as dataclasses with a ``type`` tag.

``AdamWConfig`` builds :class:`d9d_tpu_torch.optim.AdamW` (optax ``adamw``
semantics, no weight-decay mask, as ``loop/auto.py:48``).
``StochasticAdamWConfig`` builds :class:`d9d_tpu_torch.optim.StochasticAdamW`
(bf16 parameters written back by stochastic rounding).
"""

import dataclasses
from typing import Union

import torch

from d9d_tpu_torch.lr_scheduler.config import (
    PiecewiseSchedulerConfig,
    piecewise_scheduler_from_config,
)
from d9d_tpu_torch.optim.adamw import AdamW
from d9d_tpu_torch.optim.stochastic_adamw import StochasticAdamW


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    type: str = "adamw"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class StochasticAdamWConfig:
    type: str = "stochastic_adamw"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"
    seed: int = 0


OptimizerConfig = Union[AdamWConfig, StochasticAdamWConfig]


def build_optimizer(config: OptimizerConfig, params, learning_rate):
    """``learning_rate``: a float or a ``step -> lr`` schedule."""
    if isinstance(config, AdamWConfig):
        return AdamW(params, learning_rate, b1=config.b1, b2=config.b2,
                     eps=config.eps, weight_decay=config.weight_decay)
    if isinstance(config, StochasticAdamWConfig):
        moment_dtype = {"float32": torch.float32,
                        "bfloat16": torch.bfloat16}.get(config.moment_dtype)
        if moment_dtype is None:
            raise ValueError(f"moment_dtype must be 'float32' or 'bfloat16', "
                             f"got {config.moment_dtype!r}")
        return StochasticAdamW(
            params, learning_rate, b1=config.b1, b2=config.b2, eps=config.eps,
            weight_decay=config.weight_decay, moment_dtype=moment_dtype,
            seed=config.seed)
    raise TypeError(f"unknown optimizer config: {config!r}")


@dataclasses.dataclass(frozen=True)
class ConstantLRConfig:
    value: float
    type: str = "constant"


@dataclasses.dataclass(frozen=True)
class PiecewiseLRConfig:
    base_lr: float
    schedule: PiecewiseSchedulerConfig
    type: str = "piecewise"


LRSchedulerConfig = Union[ConstantLRConfig, PiecewiseLRConfig]


def build_lr_schedule(config: LRSchedulerConfig, total_steps: int | None = None):
    """A float, or a ``step -> lr`` schedule (float32 arithmetic, as the
    JAX schedule)."""
    if isinstance(config, ConstantLRConfig):
        return config.value
    if isinstance(config, PiecewiseLRConfig):
        schedule = piecewise_scheduler_from_config(
            config.schedule, total_steps=total_steps)
        return lambda step: config.base_lr * schedule(step)
    raise TypeError(f"unknown lr config: {config!r}")
