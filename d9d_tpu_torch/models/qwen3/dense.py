"""Qwen3-dense model family: backbone + causal-LM head (counterpart of
``Qwen3DenseBackbone`` / ``Qwen3DenseCausalLM`` in
``d9d_tpu/models/qwen3/dense.py``).

A model may be one pipeline stage of a larger one (``stage``, default the
whole model), as the JAX backbones are: the first stage owns the
embedding and takes token ids, later stages take hidden states; each
stage builds only its layers (``distribute_layers_for_pipeline_stage``)
under their GLOBAL ids, so a stage's parameter names are the whole
model's (``model.layers.<gid>...``) and checkpoints and exports do not
depend on the stage layout; the last stage owns the final norm and the
LM head. No activation-sharding pins and no numerics taps. ``remat`` with the ``"full"``
policy recomputes each decoder layer in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat`` with no saved
residuals); the JAX package's other policies are not ported and raise.
Layer ``i`` is ``model.layers[i]`` (a :class:`LayerStack` keyed by global
id), the counterpart of the JAX tree's ``layers_{i}``.

Weights are created directly on the device, layer by layer, from one seeded
``torch.Generator`` — there is never a full copy on the host.

The MoE family (``moe.py``) serves through the same pieces:
:func:`run_decoder_layers` (the layer loop, cache and remat) and
:class:`Qwen3CausalLMBase` (the head's entry points and ``init_cache``).
"""

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.models.qwen3.config import Qwen3DenseConfig
from d9d_tpu_torch.nn.attention import DecodeCache, PagedDecodeCache
from d9d_tpu_torch.nn.decoder import DecoderLayer
from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.norm import RMSNorm
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend
from d9d_tpu_torch.ops import compute_rope_frequencies, make_rope_cos_sin
from d9d_tpu_torch.pipelining.stage_info import (
    PipelineStageInfo,
    distribute_layers_for_pipeline_stage,
)

WHOLE_MODEL = PipelineStageInfo()


def _make_generator(seed: int | None, device: torch.device):
    if seed is None or device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


class LayerStack(nn.Module):
    """Decoder layers under their global ids: child ``str(gid)``, so
    ``layers[gid]`` and the parameter names are the whole model's whatever
    stage holds them. Iterates its layers in id order."""

    def __init__(self, layers: dict):
        super().__init__()
        for gid, layer in layers.items():
            self.add_module(str(gid), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, gid: int) -> nn.Module:
        return self._modules[str(gid)]


def stage_layers(num_layers: int, stage: PipelineStageInfo, build) -> LayerStack:
    """``build(gid)`` for every global layer id of ``stage``."""
    return LayerStack({gid: build(gid) for gid in
                       distribute_layers_for_pipeline_stage(num_layers, stage)})


def run_decoder_layers(
    backbone: nn.Module,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    cache: Optional[DecodeCache],
) -> torch.Tensor:
    """``backbone.layers`` over the embedded ``x [B, T, E]``. In decode mode
    (``backbone.decode_max_length > 0``) every layer writes ``cache`` in
    place and the shared write index advances by ``T`` once, after the last
    layer; ``backbone.config.remat`` recomputes each layer in the backward
    of a training forward only."""
    if backbone.decode_max_length > 0 and cache is None:
        raise ValueError("decode mode needs a DecodeCache")
    # remat is a backward-pass tool: decode is forward-only, and a
    # forward without autograd has nothing to recompute
    remat = (backbone.config.remat and backbone.decode_max_length == 0
             and torch.is_grad_enabled())
    for i, layer in enumerate(backbone.layers):
        if remat:
            x = checkpoint(layer, x, cos, sin, mask, use_reentrant=False)
        else:
            x = layer(x, cos, sin, mask,
                      None if cache is None else cache.layer(i, x.shape[1]))
    if cache is not None:
        cache.advance(x.shape[1])
    return x


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
        stage: PipelineStageInfo = WHOLE_MODEL,
    ):
        super().__init__()
        cfg = config
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported; the port "
                f"recomputes whole layers (remat_policy='full')"
            )
        self.config = cfg
        self.stage = stage
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        if stage.is_first:
            self.embed_tokens = TokenEmbedding(
                cfg.vocab_ranges, cfg.hidden_size, **kw
            )
        self.layers = stage_layers(cfg.num_layers, stage, lambda _: (
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
            )))
        if stage.is_last:
            self.norm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps, device=dev)
        inv_freq, att_scale = compute_rope_frequencies(
            cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=dev
        )
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        self.rope_attention_scale = att_scale

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Recompute the rope buffer (the sharded init materializes the
        model from the meta device, buffers included)."""
        cfg = self.config
        inv_freq, _ = compute_rope_frequencies(
            cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
            device=self.inv_freq.device)
        self.inv_freq.copy_(inv_freq)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        """``x [B,T]`` token ids (first stage; hidden ``[B,T,E]`` on later
        stages), ``positions [B,T]`` → hidden ``[B,T,E]``, normed on the
        last stage (see :func:`run_decoder_layers` for ``cache``)."""
        return stage_forward(self, x, positions, mask, cache)


def stage_forward(backbone: nn.Module, x, positions, mask, cache):
    """A backbone stage's forward: embed on the first stage (else take the
    carry in the compute dtype), the stage's layers, the final norm on the
    last stage."""
    if backbone.stage.is_first:
        x = backbone.embed_tokens(x)
    else:
        x = x.to(backbone.dtype)
    cos, sin = make_rope_cos_sin(
        positions, backbone.inv_freq, backbone.rope_attention_scale
    )
    x = run_decoder_layers(backbone, x, cos, sin, mask, cache)
    return backbone.norm(x) if backbone.stage.is_last else x


class Qwen3CausalLMBase(nn.Module):
    """The entry points the dense and MoE causal LMs share: ``forward`` with
    labels returns the per-token loss ``[B, T]`` (training); ``logits`` /
    ``logits_last`` serve inference and never build an autograd graph;
    :meth:`init_cache` makes the decode cache of a model built with
    ``decode_max_length > 0``.

    ``backbone`` is the backbone's class (or a partial of it), called as
    ``backbone(config, sdpa, decode_max_length=..., dtype=...,
    param_dtype=..., device=..., generator=...)``; the head's weights are
    drawn after the backbone's, from the same generator. ``device=None``
    means the card (raises without one). ``seed`` seeds the device generator
    the random weights are drawn from; on the meta device nothing is drawn
    and the sharded init (``loop/model_factory.py``) draws from ``seed``.
    ``sdpa=None`` builds the flash backend. ``param_dtype`` is the dtype
    parameters are held in (``None``: the compute ``dtype``; training
    passes ``torch.float32``, the JAX package's default). ``stage``: the
    pipeline stage this module is (default the whole model); only the
    last stage holds the head, and a non-last stage returns its hidden
    states, labels or not."""

    def __init__(
        self,
        config,
        sdpa: SdpaBackend | None,
        backbone,
        *,
        decode_max_length: int = 0,
        ce_chunk_size: "int | str" = "auto",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        seed: int | None = 0,
        stage: PipelineStageInfo = WHOLE_MODEL,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = _make_generator(seed, dev)
        self.seed = seed
        self.stage = stage
        self.config = config
        self.decode_max_length = decode_max_length
        self.dtype = dtype
        self.device = dev
        self.sdpa = sdpa if sdpa is not None else build_sdpa_backend()
        self.model = backbone(
            config, self.sdpa, decode_max_length=decode_max_length,
            dtype=dtype, param_dtype=param_dtype, device=dev, generator=gen,
            stage=stage,
        )
        if stage.is_last:
            self.lm_head = LanguageModellingHead(
                config.vocab_ranges, config.hidden_size,
                ce_chunk_size=ce_chunk_size, dtype=dtype,
                param_dtype=param_dtype, device=dev, generator=gen,
            )

    def init_cache(
        self,
        batch_size: int,
        *,
        per_row: bool = False,
        page_size: int | None = None,
        num_pages: int | None = None,
        kv_quant: str | None = None,
    ) -> "DecodeCache | PagedDecodeCache":
        """A zeroed decode cache for ``batch_size`` rows, on the model's
        device, in the compute dtype. With ``page_size`` it is the paged
        serving loop's :class:`PagedDecodeCache` (``num_pages`` pages per
        layer pool, int8 pools under ``kv_quant="int8"``, per-row indices)."""
        if self.decode_max_length <= 0:
            raise ValueError("model must be built with decode_max_length > 0")
        cfg = self.config
        if page_size is not None:
            return PagedDecodeCache(
                cfg.num_layers, batch_size, cfg.num_kv_heads,
                self.decode_max_length, cfg.head_dim, page_size=page_size,
                num_pages=num_pages, dtype=self.dtype, kv_quant=kv_quant,
                device=self.device,
            )
        return DecodeCache(
            cfg.num_layers, batch_size, cfg.num_kv_heads,
            self.decode_max_length, cfg.head_dim,
            dtype=self.dtype, device=self.device, per_row=per_row,
        )

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cache: Optional[DecodeCache] = None,
    ) -> torch.Tensor:
        """``x [B, T]`` tokens, ``positions [B, T]`` → per-token fp32 loss
        ``[B, T]`` with ``labels`` on the last stage, else the stage's hidden
        state."""
        h = self.model(x, positions, mask, cache)
        if labels is not None and self.stage.is_last:
            return self.lm_head(h, labels)
        return h

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


class Qwen3DenseCausalLM(Qwen3CausalLMBase):
    """Backbone + fused-CE LM head (entry points and options:
    :class:`Qwen3CausalLMBase`). With ``decode_max_length > 0`` the model
    runs in KV-cache decode mode and every call takes the
    :class:`DecodeCache` made by :meth:`init_cache`."""

    def __init__(
        self,
        config: Qwen3DenseConfig,
        sdpa: SdpaBackend | None = None,
        *,
        decode_max_length: int = 0,
        ce_chunk_size: "int | str" = "auto",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        seed: int | None = 0,
        stage: PipelineStageInfo = WHOLE_MODEL,
    ):
        super().__init__(
            config, sdpa, Qwen3DenseBackbone,
            decode_max_length=decode_max_length, ce_chunk_size=ce_chunk_size,
            dtype=dtype, param_dtype=param_dtype, device=device, seed=seed,
            stage=stage,
        )
