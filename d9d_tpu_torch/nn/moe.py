"""Mixture-of-Experts blocks: router, grouped experts, shared expert, layer
(counterpart of ``d9d_tpu/nn/moe.py``), on the local path — every expert
on this device. The expert-parallel path (``_forward_ep``,
``ops/ep_dispatch.py``) is not ported: ``ep_axes`` other than ``None``
raises.

Where the JAX layer sows its per-expert load into flax's ``moe_stats``
collection, the port's layer hands ``tokens_per_expert`` to a collector
that the caller opens with :func:`collect_tokens_per_expert` around ONE
forward. A layer called outside such a window counts nothing — in
particular the recomputation of a layer's forward under full remat
(``torch.utils.checkpoint``), which runs during the backward, so every
layer call is counted once, as the JAX ``sow`` counts it.
"""

import contextlib
import dataclasses
from typing import Literal, Optional

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.init import variance_scaling_uniform_
from d9d_tpu_torch.nn.linear import Projection
from d9d_tpu_torch.nn.logical_axes import (
    EMBED,
    EXPERT,
    EXPERT_EMBED,
    EXPERT_MLP,
)
from d9d_tpu_torch.nn.mlp import SwiGLU
from d9d_tpu_torch.ops.moe import grouped_swiglu_apply, sort_tokens_by_expert
from d9d_tpu_torch.ops.moe_ffn import MOE_FFN_VARIANTS, fused_moe_ffn_apply

MoeFfn = Literal["aligned", "gather", "gather_combine"]


@dataclasses.dataclass(frozen=True)
class SharedExpertParameters:
    """Config of the optional shared expert."""

    intermediate_size: int
    enable_gate: bool = False


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last dim, largest
    first, ties lower index first — ``lax.top_k``'s order. ``torch.topk``
    gives tied values in another order; a stable descending sort does not."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


class TopKRouter(nn.Module):
    """Softmax gate (fp32) → optional expert bias (selection only) →
    optional group-limited eligibility → top-k → optional renormalization.
    Parameter: ``gate.weight [E, dim]``; buffer ``expert_bias [E]`` fp32
    with ``enable_expert_bias`` (not a parameter: no gradient, no update)."""

    def __init__(
        self,
        dim: int,
        num_experts: int,
        top_k: int,
        *,
        renormalize_probabilities: bool = True,
        enable_expert_bias: bool = False,
        n_group: int = 1,
        topk_group: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if n_group > 1 and num_experts % n_group != 0:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"n_group {n_group}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.renormalize_probabilities = renormalize_probabilities
        self.n_group, self.topk_group = n_group, topk_group
        self.gate = Projection(dim, num_experts, axes=(EMBED, None),
                               dtype=dtype, param_dtype=param_dtype,
                               device=device, generator=generator)
        self.register_buffer("expert_bias", torch.zeros(
            num_experts, dtype=torch.float32, device=resolve_device(device))
            if enable_expert_bias else None)

    def forward(self, hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``hidden [..., D]`` → ``(indices [..., K] int64, probs [..., K]
        fp32)``."""
        probs = torch.softmax(self.gate(hidden).float(), dim=-1)
        sel = probs
        if self.expert_bias is not None:
            sel = sel + self.expert_bias
        if self.n_group > 1:
            per = self.num_experts // self.n_group
            group_score = sel.reshape(*sel.shape[:-1], self.n_group,
                                      per).amax(dim=-1)
            top_g = top_k_indices(group_score, self.topk_group)
            gmask = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
                -1, top_g, True)
            sel = sel.masked_fill(~gmask.repeat_interleave(per, dim=-1),
                                  float("-inf"))
        idx = top_k_indices(sel, self.top_k)
        selected = torch.gather(probs, -1, idx)
        if self.renormalize_probabilities:
            selected = selected / (selected.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, selected


class GroupedSwiGLU(nn.Module):
    """E SwiGLU experts. Parameters ``gate_proj``, ``up_proj`` ``[E, hidden,
    inter]`` and ``down_proj [E, inter, hidden]`` — the JAX layout, not
    transposed — drawn as flax's ``variance_scaling(1/3, "fan_in",
    "uniform", in_axis=1, out_axis=2)`` draws them (fan-in ``E * in``)."""

    def __init__(
        self,
        hidden_dim: int,
        intermediate_dim: int,
        num_experts: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        dev = resolve_device(device)

        def weight(din, dout):
            w = torch.empty((num_experts, din, dout),
                            dtype=param_dtype or dtype, device=dev)
            variance_scaling_uniform_(w, 1.0 / 3.0, num_experts * din,
                                      generator)
            return nn.Parameter(w)

        self.gate_proj = weight(hidden_dim, intermediate_dim)
        self.up_proj = weight(hidden_dim, intermediate_dim)
        self.down_proj = weight(intermediate_dim, hidden_dim)

    def logical_axes(self) -> dict:
        return {"gate_proj": (EXPERT, EXPERT_EMBED, EXPERT_MLP),
                "up_proj": (EXPERT, EXPERT_EMBED, EXPERT_MLP),
                "down_proj": (EXPERT, EXPERT_MLP, EXPERT_EMBED)}

    def forward(self, permuted_x, permuted_probs, group_sizes) -> torch.Tensor:
        """Expert-sorted rows ``[M, D]`` + probs ``[M]`` → prob-weighted
        outputs ``[M, D]`` through the unfused chain (``MoELayer`` runs the
        fused kernels on these parameters instead)."""
        return grouped_swiglu_apply(permuted_x, permuted_probs, group_sizes,
                                    self.gate_proj, self.up_proj,
                                    self.down_proj, self.dtype)


class SharedSwiGLU(nn.Module):
    """Always-on expert (``expert``, a SwiGLU) with an optional sigmoid
    gate (``gate``, a width-1 projection)."""

    def __init__(
        self,
        hidden_size: int,
        params_config: SharedExpertParameters,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.expert = SwiGLU(hidden_size, params_config.intermediate_size, **kw)
        self.gate = (Projection(hidden_size, 1, **kw)
                     if params_config.enable_gate else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.expert(x)
        if self.gate is not None:
            out = out * torch.sigmoid(self.gate(x))
        return out


@contextlib.contextmanager
def collect_tokens_per_expert(module: nn.Module):
    """Collect the ``tokens_per_expert`` of every :class:`MoELayer` of
    ``module`` called inside the window → a list of ``[E]`` int64 device
    tensors, one per layer call (empty for a model without MoE layers)."""
    layers = [m for m in module.modules() if isinstance(m, MoELayer)]
    counts: list[torch.Tensor] = []
    for layer in layers:
        layer._stats_sink = counts
    try:
        yield counts
    finally:
        for layer in layers:
            layer._stats_sink = None


class MoELayer(nn.Module):
    """Router + expert-sorted dispatch + grouped experts + combine (+ shared
    expert), on the local path. Submodules ``router``, ``grouped_experts``,
    ``shared_expert_module`` — the JAX layer's names.

    ``moe_ffn`` selects the fused expert-FFN kernel the layer runs: the
    aligned one (``"aligned"``), the row-gathering one (``"gather"``) or the
    gathering and combining one (``"gather_combine"``) — see
    ``ops/moe_ffn.py``. Every value computes the same function; there is no
    unfused choice (the unfused chain is the kernels' backward and test
    oracle).
    """

    def __init__(
        self,
        hidden_dim: int,
        intermediate_dim_grouped: int,
        num_grouped_experts: int,
        top_k: int,
        *,
        router_renormalize_probabilities: bool = True,
        router_enable_expert_bias: bool = False,
        router_n_group: int = 1,
        router_topk_group: int = 1,
        shared_expert: Optional[SharedExpertParameters] = None,
        ep_axes: Optional[tuple[str, ...]] = None,
        token_axes=None,
        ep_capacity_factor: Optional[float] = None,
        routed_scaling: float = 1.0,
        moe_ffn: MoeFfn = "aligned",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if ep_axes is not None or token_axes is not None:
            raise NotImplementedError(
                "MoELayer: the expert-parallel path (ep_axes, token_axes) is "
                "not ported yet (ROADMAP A3); the local path takes "
                "ep_axes=None")
        if moe_ffn not in MOE_FFN_VARIANTS:
            raise ValueError(f"moe_ffn {moe_ffn!r} is not one of "
                             f"{sorted(MOE_FFN_VARIANTS)}")
        # ep_capacity_factor sizes the EP dispatch buffer only; the local
        # path ignores it, as in the JAX package
        self.num_experts = num_grouped_experts
        self.routed_scaling = routed_scaling
        self.moe_ffn = moe_ffn
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.router = TopKRouter(
            hidden_dim, num_grouped_experts, top_k,
            renormalize_probabilities=router_renormalize_probabilities,
            enable_expert_bias=router_enable_expert_bias,
            n_group=router_n_group, topk_group=router_topk_group, **kw)
        self.grouped_experts = GroupedSwiGLU(
            hidden_dim, intermediate_dim_grouped, num_grouped_experts, **kw)
        self.shared_expert_module = (
            SharedSwiGLU(hidden_dim, shared_expert, **kw)
            if shared_expert is not None else None)
        self._stats_sink: list[torch.Tensor] | None = None

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """``[B, T, D]`` → ``[B, T, D]``."""
        shape = hidden.shape
        shared = None
        if self.shared_expert_module is not None:
            shared = self.shared_expert_module(hidden)
        topk_ids, topk_probs = self.router(hidden)
        k = topk_ids.shape[-1]
        sort = sort_tokens_by_expert(topk_ids.reshape(-1, k), self.num_experts)
        if self._stats_sink is not None:
            # the per-expert pair counts ARE the sort's group sizes
            self._stats_sink.append(sort.group_sizes)
        gather, combine = MOE_FFN_VARIANTS[self.moe_ffn]
        experts = self.grouped_experts
        out = fused_moe_ffn_apply(
            hidden.reshape(-1, shape[-1]), topk_probs.reshape(-1, k), sort,
            experts.gate_proj, experts.up_proj, experts.down_proj, self.dtype,
            num_experts=self.num_experts, gather=gather, combine=combine,
        ).reshape(shape)
        if self.routed_scaling != 1.0:
            # on the routed output only, as a scalar of the output's dtype
            scale = torch.tensor(self.routed_scaling, dtype=out.dtype)
            out = out * float(scale)
        if shared is not None:
            out = out + shared
        return out


__all__ = [
    "GroupedSwiGLU",
    "MoELayer",
    "SharedExpertParameters",
    "SharedSwiGLU",
    "TopKRouter",
    "collect_tokens_per_expert",
    "grouped_swiglu_apply",
    "top_k_indices",
]
