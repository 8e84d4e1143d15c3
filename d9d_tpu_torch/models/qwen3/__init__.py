from d9d_tpu_torch.models.qwen3.config import Qwen3DenseConfig
from d9d_tpu_torch.models.qwen3.dense import (
    Qwen3DenseBackbone,
    Qwen3DenseCausalLM,
)

__all__ = ["Qwen3DenseConfig", "Qwen3DenseBackbone", "Qwen3DenseCausalLM"]
