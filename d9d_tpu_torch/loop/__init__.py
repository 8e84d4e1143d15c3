from d9d_tpu_torch.loop.auto import (
    AdamWConfig,
    ConstantLRConfig,
    PiecewiseLRConfig,
    StochasticAdamWConfig,
    build_lr_schedule,
    build_optimizer,
)
from d9d_tpu_torch.loop.components.data_loader import StatefulDataLoader
from d9d_tpu_torch.loop.config import TrainerConfig
from d9d_tpu_torch.loop.control.providers import (
    AdamWProvider,
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
)
from d9d_tpu_torch.loop.control.task import PipelineTrainTask, TrainTask
from d9d_tpu_torch.loop.generate import generate
from d9d_tpu_torch.loop.serve import ContinuousBatcher, ServeStats
from d9d_tpu_torch.loop.tasks import CausalLMTask
from d9d_tpu_torch.loop.train import Trainer
from d9d_tpu_torch.loop.train_step import build_train_step

__all__ = [
    "AdamWConfig",
    "AdamWProvider",
    "CausalLMTask",
    "ConstantLRConfig",
    "ContinuousBatcher",
    "DatasetProvider",
    "ModelProvider",
    "OptimizerProvider",
    "PipelineTrainTask",
    "PiecewiseLRConfig",
    "ServeStats",
    "StatefulDataLoader",
    "StochasticAdamWConfig",
    "TrainTask",
    "Trainer",
    "TrainerConfig",
    "build_lr_schedule",
    "build_optimizer",
    "build_train_step",
    "generate",
]
