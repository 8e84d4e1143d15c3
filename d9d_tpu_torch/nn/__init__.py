from d9d_tpu_torch.nn.attention import (
    DecodeCache,
    GroupedQueryAttention,
    LayerKVCache,
    PagedDecodeCache,
)
from d9d_tpu_torch.nn.decoder import DecoderLayer
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.nn.moe import (
    GroupedSwiGLU,
    MoELayer,
    SharedExpertParameters,
    SharedSwiGLU,
    TopKRouter,
    collect_tokens_per_expert,
)
from d9d_tpu_torch.nn.norm import RMSNorm

__all__ = [
    "DecodeCache",
    "DecoderLayer",
    "GroupedQueryAttention",
    "GroupedSwiGLU",
    "LanguageModellingHead",
    "LayerKVCache",
    "MoELayer",
    "PagedDecodeCache",
    "RMSNorm",
    "SharedExpertParameters",
    "SharedSwiGLU",
    "SwiGLU",
    "TokenEmbedding",
    "TopKRouter",
    "collect_tokens_per_expert",
]
