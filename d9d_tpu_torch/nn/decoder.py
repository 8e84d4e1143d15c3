"""Pre-norm transformer decoder layer (counterpart of
``d9d_tpu/nn/decoder.py``)."""

from typing import Optional

import torch
from torch import nn

from d9d_tpu_torch.nn.attention import GroupedQueryAttention, LayerKVCache
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import RopeStyle


class DecoderLayer(nn.Module):
    """``x + attn(norm(x))`` then ``x + mlp(norm(x))``. Submodules:
    ``input_layernorm``, ``self_attn``, ``post_attention_layernorm``,
    ``mlp`` — the JAX layer's names."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        num_kv_heads: int,
        head_dim: int,
        intermediate_size: int,
        sdpa: SdpaBackend,
        *,
        qk_norm: bool = True,
        rope_style: RopeStyle = RopeStyle.HALF,
        window_size: int | None = None,
        use_sinks: bool = False,
        use_output_gate: bool = False,
        fused_qkv: bool = False,
        norm_eps: float = 1e-6,
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.input_layernorm = RMSNorm(hidden_size, eps=norm_eps, device=device)
        self.self_attn = GroupedQueryAttention(
            hidden_size=hidden_size,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
            sdpa=sdpa,
            qk_norm=qk_norm,
            rope_style=rope_style,
            window_size=window_size,
            use_sinks=use_sinks,
            use_output_gate=use_output_gate,
            fused_qkv=fused_qkv,
            decode_max_length=decode_max_length,
            dtype=dtype,
            param_dtype=param_dtype,
            device=device,
            generator=generator,
        )
        self.post_attention_layernorm = RMSNorm(
            hidden_size, eps=norm_eps, device=device
        )
        self.mlp = SwiGLU(
            hidden_size, intermediate_size, dtype=dtype,
            param_dtype=param_dtype, device=device, generator=generator,
        )

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[LayerKVCache] = None,
    ) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, cache)
        return x + self.mlp(self.post_attention_layernorm(x))
