"""Qwen3-MoE model family: config, decoder layer, backbone and causal-LM
head (counterpart of ``d9d_tpu/models/qwen3/moe.py``).

The dense family's structure with the FFN replaced by a :class:`MoELayer`
(every layer sparse, except the ``mlp_only_layers``, which keep a dense
SwiGLU). One pipeline stage of the model or all of it (``stage``, as the
dense family's: the embedding on the first stage, the stage's layers under
their global ids, the final norm and the head on the last), local
experts: training, full-sequence
forward and KV-cache decode (``decode_max_length > 0``: ``generate`` and
``ContinuousBatcher`` serve it as they serve the dense model, through the
entry points of :class:`~d9d_tpu_torch.models.qwen3.dense.Qwen3CausalLMBase`).
The config has the JAX dataclass's fields; those the port cannot honour yet
raise when the model is built: GDN layers (``linear_attention_layers``),
MLA (``mla``) and remat policies other than ``"full"``. Expert parallelism
(``ep_axes``, ``moe_token_axes``, ``ep_capacity_factor``) goes to every
MoE layer, as in the JAX package; such a model trains under
``fsdp_ep_plan`` and is not served (ROADMAP A10).

``moe_ffn`` picks the fused expert-FFN kernel of every MoE layer
(``"aligned"``, ``"gather"``, ``"gather_combine"``; ``ops/moe_ffn.py``).
Layer ``i`` is ``model.layers[i]``, the counterpart of ``layers_{i}``.
"""

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.models.qwen3.dense import (
    WHOLE_MODEL,
    Qwen3CausalLMBase,
    stage_forward,
    stage_layers,
)
from d9d_tpu_torch.nn.attention import (
    DecodeCache,
    GroupedQueryAttention,
    LayerKVCache,
)
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.nn.moe import MoeFfn, MoELayer, SharedExpertParameters
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import (
    RopeScaling,
    RopeScalingNone,
    compute_rope_frequencies,
)
from d9d_tpu_torch.pipelining.stage_info import PipelineStageInfo


@dataclasses.dataclass(frozen=True)
class Qwen3MoeConfig:
    vocab_ranges: tuple[tuple[str, int], ...]
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    moe_intermediate_size: int
    num_experts: int
    num_experts_per_tok: int
    # dense FFN width for layers listed in mlp_only_layers
    intermediate_size: int = 0
    mlp_only_layers: tuple[int, ...] = ()
    shared_expert: Optional[SharedExpertParameters] = None
    norm_topk_prob: bool = True
    rope_theta: float = 1_000_000.0
    rope_scaling: RopeScaling = RopeScalingNone()
    qk_norm: bool = True
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "full"
    use_output_gate: bool = False
    fused_qkv: bool = False
    rope_fraction: float = 1.0
    zero_centered_norms: bool = False
    ep_axes: Optional[tuple[str, ...]] = None
    moe_token_axes: Optional[tuple[tuple[str, ...], tuple[str, ...]]] = None
    linear_attention_layers: tuple[int, ...] = ()
    gdn_qk_heads: int = 0
    gdn_v_heads: int = 0
    gdn_head_qk_dim: int = 0
    gdn_head_v_dim: int = 0
    gdn_conv_size: int = 4
    ep_capacity_factor: Optional[float] = None
    # MLA geometry (the JAX package's MLAParameters); not ported: a config
    # that sets it raises when the model is built
    mla: Optional[object] = None
    routed_scaling_factor: float = 1.0
    router_n_group: int = 1
    router_topk_group: int = 1

    @property
    def vocab_size(self) -> int:
        return sum(s for _, s in self.vocab_ranges)

    @staticmethod
    def tiny(vocab_size: int = 256, ep_axes=None) -> "Qwen3MoeConfig":
        """2-layer CPU-runnable config."""
        return Qwen3MoeConfig(
            vocab_ranges=(("default", vocab_size),),
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            moe_intermediate_size=64,
            num_experts=8,
            num_experts_per_tok=2,
            remat=False,
            ep_axes=ep_axes,
        )

    @staticmethod
    def qwen3_30b_a3b(vocab_size: int = 151_936,
                      ep_axes=None) -> "Qwen3MoeConfig":
        """Qwen3-30B-A3B geometry."""
        return Qwen3MoeConfig(
            vocab_ranges=(("default", vocab_size),),
            hidden_size=2048,
            num_layers=48,
            num_heads=32,
            num_kv_heads=4,
            head_dim=128,
            moe_intermediate_size=768,
            num_experts=128,
            num_experts_per_tok=8,
            ep_axes=ep_axes,
        )


def _check_ported(cfg: Qwen3MoeConfig) -> None:
    unported = {
        "linear_attention_layers (GDN)": bool(cfg.linear_attention_layers),
        "mla": cfg.mla is not None,
    }
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(
            f"Qwen3MoeConfig: {', '.join(on)} not ported yet")
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported; the port "
            f"recomputes whole layers (remat_policy='full')")


class Qwen3MoeDecoderLayer(nn.Module):
    """``x + attn(norm(x))`` then ``x + mlp(norm(x))`` with ``mlp`` a
    :class:`MoELayer`, or a dense SwiGLU for the ``mlp_only_layers``."""

    def __init__(
        self,
        config: Qwen3MoeConfig,
        sdpa: SdpaBackend,
        layer_idx: int,
        *,
        moe_ffn: MoeFfn = "aligned",
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = config
        zc = cfg.zero_centered_norms
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps,
                                       zero_centered=zc, device=device)
        self.self_attn = GroupedQueryAttention(
            hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, sdpa=sdpa,
            qk_norm=cfg.qk_norm, qk_norm_zero_centered=zc,
            use_output_gate=cfg.use_output_gate, fused_qkv=cfg.fused_qkv,
            rope_fraction=cfg.rope_fraction,
            decode_max_length=decode_max_length, **kw)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, eps=cfg.norm_eps, zero_centered=zc, device=device)
        if layer_idx in cfg.mlp_only_layers:
            self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, **kw)
        else:
            self.mlp = MoELayer(
                cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
                cfg.num_experts_per_tok,
                router_renormalize_probabilities=cfg.norm_topk_prob,
                shared_expert=cfg.shared_expert,
                ep_axes=cfg.ep_axes,
                token_axes=cfg.moe_token_axes,
                ep_capacity_factor=cfg.ep_capacity_factor,
                routed_scaling=cfg.routed_scaling_factor,
                router_n_group=cfg.router_n_group,
                router_topk_group=cfg.router_topk_group,
                moe_ffn=moe_ffn, **kw)

    def forward(self, x, cos, sin, mask: Optional[torch.Tensor] = None,
                cache: Optional[LayerKVCache] = None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen3MoeBackbone(nn.Module):
    def __init__(
        self,
        config: Qwen3MoeConfig,
        sdpa: SdpaBackend,
        *,
        moe_ffn: MoeFfn = "aligned",
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
        stage: PipelineStageInfo = WHOLE_MODEL,
    ):
        super().__init__()
        cfg = config
        _check_ported(cfg)
        self.config = cfg
        self.stage = stage
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        if stage.is_first:
            self.embed_tokens = TokenEmbedding(cfg.vocab_ranges,
                                               cfg.hidden_size, **kw)
        self.layers = stage_layers(cfg.num_layers, stage, lambda i: (
            Qwen3MoeDecoderLayer(cfg, sdpa, i, moe_ffn=moe_ffn,
                                 decode_max_length=decode_max_length, **kw)))
        if stage.is_last:
            self.norm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps,
                                zero_centered=cfg.zero_centered_norms,
                                device=dev)
        # partial rotary: frequencies over the rotary dim, not head_dim
        inv_freq, att_scale = compute_rope_frequencies(
            int(cfg.head_dim * cfg.rope_fraction), cfg.rope_theta,
            cfg.rope_scaling, device=dev)
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        self.rope_attention_scale = att_scale

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Recompute the rope buffer (the sharded init materializes the
        model from the meta device, buffers included)."""
        cfg = self.config
        inv_freq, _ = compute_rope_frequencies(
            int(cfg.head_dim * cfg.rope_fraction), cfg.rope_theta,
            cfg.rope_scaling, device=self.inv_freq.device)
        self.inv_freq.copy_(inv_freq)

    def forward(self, x, positions, mask: Optional[torch.Tensor] = None,
                cache: Optional[DecodeCache] = None):
        """``x [B,T]`` token ids (hidden states after the first stage),
        ``positions [B,T]`` → hidden ``[B,T,E]`` (``cache``: as the dense
        backbone's, never under remat)."""
        return stage_forward(self, x, positions, mask, cache)


class Qwen3MoeCausalLM(Qwen3CausalLMBase):
    """Backbone + fused-CE LM head (entry points and options:
    :class:`Qwen3CausalLMBase`; ``moe_ffn`` as the module says). With
    ``decode_max_length > 0`` the model runs in KV-cache decode mode, as the
    dense one does: every MoE layer routes the step's 1–8 tokens a row
    through the same fused kernels, with no readback."""

    def __init__(
        self,
        config: Qwen3MoeConfig,
        sdpa: SdpaBackend | None = None,
        *,
        moe_ffn: MoeFfn = "aligned",
        decode_max_length: int = 0,
        ce_chunk_size: "int | str" = "auto",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        seed: int | None = 0,
        stage: PipelineStageInfo = WHOLE_MODEL,
    ):
        super().__init__(
            config, sdpa, functools.partial(Qwen3MoeBackbone, moe_ffn=moe_ffn),
            decode_max_length=decode_max_length, ce_chunk_size=ce_chunk_size,
            dtype=dtype, param_dtype=param_dtype, device=device, seed=seed,
            stage=stage)
