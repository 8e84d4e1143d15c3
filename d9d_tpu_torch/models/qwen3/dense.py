"""Qwen3-dense model family: backbone + causal-LM head (counterpart of
``Qwen3DenseBackbone`` / ``Qwen3DenseCausalLM`` in
``d9d_tpu/models/qwen3/dense.py``).

Single pipeline stage only (the whole model on one device); no remat, no
activation-sharding pins, no numerics taps — those belong to the training
and multi-device paths, which are not ported yet. Layer ``i`` is
``model.layers[i]``, the counterpart of the JAX tree's ``layers_{i}``.

Weights are created directly on the device, layer by layer, from one seeded
``torch.Generator`` — there is never a full copy on the host.
"""

from typing import Optional

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.models.qwen3.config import Qwen3DenseConfig
from d9d_tpu_torch.nn.attention import DecodeCache
from d9d_tpu_torch.nn.decoder import DecoderLayer
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import compute_rope_frequencies, make_rope_cos_sin


def _make_generator(seed: int | None, device: torch.device):
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class Qwen3DenseBackbone(nn.Module):
    def __init__(
        self,
        config: Qwen3DenseConfig,
        sdpa: SdpaBackend,
        *,
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = config
        self.config = cfg
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        self.embed_tokens = TokenEmbedding(
            cfg.vocab_ranges, cfg.hidden_size, **kw
        )
        self.layers = nn.ModuleList(
            DecoderLayer(
                hidden_size=cfg.hidden_size,
                num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim,
                intermediate_size=cfg.intermediate_size,
                sdpa=sdpa,
                qk_norm=cfg.qk_norm,
                window_size=cfg.window_size,
                use_sinks=cfg.use_sinks,
                use_output_gate=cfg.use_output_gate,
                fused_qkv=cfg.fused_qkv,
                norm_eps=cfg.norm_eps,
                decode_max_length=decode_max_length,
                **kw,
            )
            for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps, device=dev)
        inv_freq, att_scale = compute_rope_frequencies(
            cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=dev
        )
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        self.rope_attention_scale = att_scale

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        """``x [B,T]`` token ids, ``positions [B,T]`` → hidden ``[B,T,E]``.
        In decode mode every layer writes ``cache`` in place and the shared
        write index advances by ``T`` once, after the last layer."""
        if self.decode_max_length > 0 and cache is None:
            raise ValueError("decode mode needs a DecodeCache")
        x = self.embed_tokens(x)
        cos, sin = make_rope_cos_sin(
            positions, self.inv_freq, self.rope_attention_scale
        )
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, mask,
                      None if cache is None else cache.layer(i, x.shape[1]))
        if cache is not None:
            cache.advance(x.shape[1])
        return self.norm(x)


class Qwen3DenseCausalLM(nn.Module):
    """Backbone + LM head; ``logits`` / ``logits_last`` serve inference.

    ``device=None`` means the card (raises without one). ``seed`` seeds the
    device generator the random weights are drawn from. ``sdpa=None`` builds
    the flash backend. With ``decode_max_length > 0`` the model runs in
    KV-cache decode mode and every call takes the :class:`DecodeCache` made
    by :meth:`init_cache`.
    """

    def __init__(
        self,
        config: Qwen3DenseConfig,
        sdpa: SdpaBackend | None = None,
        *,
        decode_max_length: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        seed: int | None = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = _make_generator(seed, dev)
        self.config = config
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        self.device = dev
        self.sdpa = sdpa if sdpa is not None else build_sdpa_backend()
        self.model = Qwen3DenseBackbone(
            config, self.sdpa, decode_max_length=decode_max_length,
            dtype=dtype, param_dtype=param_dtype, device=dev, generator=gen,
        )
        self.lm_head = LanguageModellingHead(
            config.vocab_ranges, config.hidden_size, dtype=dtype,
            param_dtype=param_dtype, device=dev, generator=gen,
        )

    def init_cache(self, batch_size: int, *, per_row: bool = False) -> DecodeCache:
        """A zeroed decode cache for ``batch_size`` rows, on the model's
        device, in the compute dtype."""
        if self.decode_max_length <= 0:
            raise ValueError("model must be built with decode_max_length > 0")
        cfg = self.config
        return DecodeCache(
            cfg.num_layers, batch_size, cfg.num_kv_heads,
            self.decode_max_length, cfg.head_dim,
            dtype=self.dtype, device=self.device, per_row=per_row,
        )

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        return self.model(x, positions, mask, cache)

    @torch.no_grad()
    def logits(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        return self.lm_head.logits(self.model(x, positions, mask, cache))

    @torch.no_grad()
    def logits_last(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        """Logits for the LAST position only ``[B, 1, V]`` — the prefill
        fast path: the backbone runs over the full prompt (writing caches in
        decode mode) but the LM head product covers one row instead of P."""
        h = self.model(x, positions, mask, cache)
        return self.lm_head.logits(h[:, -1:])
