from d9d_tpu_torch.nn.attention import DecodeCache, GroupedQueryAttention, LayerKVCache
from d9d_tpu_torch.nn.decoder import DecoderLayer
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.nn.norm import RMSNorm

__all__ = [
    "DecodeCache",
    "DecoderLayer",
    "GroupedQueryAttention",
    "LanguageModellingHead",
    "LayerKVCache",
    "RMSNorm",
    "SwiGLU",
    "TokenEmbedding",
]
