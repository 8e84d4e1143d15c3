from d9d_tpu_torch.models.qwen3.config import Qwen3DenseConfig
from d9d_tpu_torch.models.qwen3.dense import (
    Qwen3DenseBackbone,
    Qwen3DenseCausalLM,
)
from d9d_tpu_torch.models.qwen3.moe import (
    Qwen3MoeBackbone,
    Qwen3MoeCausalLM,
    Qwen3MoeConfig,
    Qwen3MoeDecoderLayer,
)

__all__ = [
    "Qwen3DenseBackbone",
    "Qwen3DenseCausalLM",
    "Qwen3DenseConfig",
    "Qwen3MoeBackbone",
    "Qwen3MoeCausalLM",
    "Qwen3MoeConfig",
    "Qwen3MoeDecoderLayer",
]
