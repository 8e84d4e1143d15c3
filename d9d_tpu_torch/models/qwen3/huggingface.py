"""HuggingFace ⇄ port state mappers for Qwen3 dense and MoE (counterpart of
``d9d_tpu/models/qwen3/huggingface.py``).

The port's parameters mostly ARE the HF layout: a projection is a torch
``weight [out, in]`` under the HF name, and the vocabulary ranges are one
concatenated table (``model.embed_tokens.weight``, ``lm_head.weight``),
so most of the JAX mappers' transposes and range splits vanish here and a
name maps to itself. What is left:

- the router: ``mlp.router.gate.weight`` ⇄ HF ``mlp.gate.weight``
  (a rename);
- the experts, one stack ``[E, in, out]`` a projection
  (``mlp.grouped_experts.{gate,up,down}_proj``) ⇄ transformers v4's
  per-expert ``mlp.experts.{e}.{proj}.weight [out, in]``
  (``experts_format="module_list"``) or v5's fused
  ``mlp.experts.gate_up_proj [E, 2i, h]`` and ``mlp.experts.down_proj
  [E, h, i]`` (``"fused"``);
- tied word embeddings: the HF table feeds both the embedding and the
  head, and the head is not exported.

The HF side is the JAX package's exactly: the same names, shapes, dtypes
and values. ``layers`` / ``include_*`` restrict a mapper to part of the
model, as there.
"""

import torch

from d9d_tpu_torch.model_state.mapper import (
    ModelStateMapper,
    ModelStateMapperIdentity,
    ModelStateMapperParallel,
    ModelStateMapperRename,
    StateDict,
    StateGroup,
)

_EXPERTS_FORMATS = ("module_list", "fused")
_EMBED = "model.embed_tokens.weight"
_HEAD = "lm_head.weight"
_NORM = "model.norm.weight"


def _one_group(inputs, outputs) -> frozenset[StateGroup]:
    return frozenset([StateGroup(inputs=frozenset(inputs),
                                 outputs=frozenset(outputs))])


class _Fanout(ModelStateMapper):
    """One tensor under several names (tied embeddings: the HF table
    feeds the embedding and the head)."""

    def __init__(self, source: str, targets: list[str]):
        self._source = source
        self._targets = list(targets)

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group([self._source], self._targets)

    def apply(self, group: StateDict) -> StateDict:
        return {t: group[self._source].clone() for t in self._targets}


class _StackExpertsTransposed(ModelStateMapper):
    """E per-expert ``[out, in]`` weights → one ``[E, in, out]`` stack."""

    def __init__(self, sources: list[str], target: str):
        self._sources = list(sources)
        self._target = target

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group(self._sources, [self._target])

    def apply(self, group: StateDict) -> StateDict:
        return {self._target: torch.stack(
            [group[s].transpose(0, 1) for s in self._sources]).contiguous()}


class _UnstackExpertsTransposed(ModelStateMapper):
    """Inverse of :class:`_StackExpertsTransposed`."""

    def __init__(self, source: str, targets: list[str]):
        self._source = source
        self._targets = list(targets)

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group([self._source], self._targets)

    def apply(self, group: StateDict) -> StateDict:
        t = group[self._source]
        return {name: t[e].transpose(0, 1).contiguous()
                for e, name in enumerate(self._targets)}


class _FusedExpertsFromHF(ModelStateMapper):
    """HF v5 fused ``gate_up_proj [E, 2i, h]`` → gate and up stacks
    ``[E, h, i]``: the last two dims transposed, the last cut in half."""

    def __init__(self, source: str, gate_target: str, up_target: str):
        self._source = source
        self._gate = gate_target
        self._up = up_target

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group([self._source], [self._gate, self._up])

    def apply(self, group: StateDict) -> StateDict:
        t = group[self._source].transpose(-1, -2)
        if t.shape[-1] % 2:
            raise ValueError(f"{self._source}: fused gate_up dim "
                             f"{t.shape[-1]} is odd")
        half = t.shape[-1] // 2
        return {self._gate: t[..., :half].contiguous(),
                self._up: t[..., half:].contiguous()}


class _FusedExpertsToHF(ModelStateMapper):
    """Inverse of :class:`_FusedExpertsFromHF`."""

    def __init__(self, gate_source: str, up_source: str, target: str):
        self._gate = gate_source
        self._up = up_source
        self._target = target

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group([self._gate, self._up], [self._target])

    def apply(self, group: StateDict) -> StateDict:
        fused = torch.cat([group[self._gate], group[self._up]], dim=-1)
        return {self._target: fused.transpose(-1, -2).contiguous()}


class _TransposedRenameLast2(ModelStateMapper):
    """Rename, and swap the last two dims (an expert stack)."""

    def __init__(self, name_from: str, name_to: str):
        self._name_from = name_from
        self._name_to = name_to

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return _one_group([self._name_from], [self._name_to])

    def apply(self, group: StateDict) -> StateDict:
        return {self._name_to:
                group[self._name_from].transpose(-1, -2).contiguous()}


def _same(name: str) -> ModelStateMapper:
    return ModelStateMapperIdentity(name)


def _attention_names(config, i: int, *, gate: bool, sinks: bool) -> list[str]:
    at = f"model.layers.{i}"
    names = [f"{at}.self_attn.{p}.weight"
             for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
    if gate and config.use_output_gate:
        names.append(f"{at}.self_attn.gate_proj.weight")
    if config.qk_norm:
        names += [f"{at}.self_attn.q_norm.weight",
                  f"{at}.self_attn.k_norm.weight"]
    if sinks and config.use_sinks:
        names.append(f"{at}.self_attn.sinks")
    return names + [f"{at}.input_layernorm.weight",
                    f"{at}.post_attention_layernorm.weight"]


def _dense_mlp_names(i: int) -> list[str]:
    return [f"model.layers.{i}.mlp.{p}.weight"
            for p in ("gate_proj", "up_proj", "down_proj")]


def _embed_head_from_hf(*, tie_word_embeddings, include_embed, include_head):
    mappers: list[ModelStateMapper] = []
    if include_head:
        mappers.append(_same(_NORM))
    if tie_word_embeddings and include_embed and include_head:
        mappers.append(_Fanout(_EMBED, [_EMBED, _HEAD]))
        return mappers
    if include_embed:
        mappers.append(_same(_EMBED))
    if include_head:
        mappers.append(ModelStateMapperRename(_EMBED, _HEAD)
                       if tie_word_embeddings else _same(_HEAD))
    return mappers


def _embed_head_to_hf(*, tie_word_embeddings, include_embed, include_head):
    mappers: list[ModelStateMapper] = [_same(_EMBED)] if include_embed else []
    if include_head:
        mappers.append(_same(_NORM))
        if not tie_word_embeddings:  # tied: the head is not exported
            mappers.append(_same(_HEAD))
    return mappers


def _dense_layers(config, layers) -> list[ModelStateMapper]:
    out = []
    for i in layers if layers is not None else range(config.num_layers):
        names = _attention_names(config, i, gate=True, sinks=True)
        out += [_same(n) for n in names + _dense_mlp_names(i)]
    return out


def qwen3_dense_from_hf_mapper(config, *, tie_word_embeddings: bool = False,
                               layers: list[int] | None = None,
                               include_embed: bool = True,
                               include_head: bool = True) -> ModelStateMapper:
    """HF checkpoint names → the port's ``Qwen3DenseCausalLM``
    parameters."""
    return ModelStateMapperParallel(
        _embed_head_from_hf(tie_word_embeddings=tie_word_embeddings,
                            include_embed=include_embed,
                            include_head=include_head)
        + _dense_layers(config, layers))


def qwen3_dense_to_hf_mapper(config, *, tie_word_embeddings: bool = False,
                             layers: list[int] | None = None,
                             include_embed: bool = True,
                             include_head: bool = True) -> ModelStateMapper:
    """The port's ``Qwen3DenseCausalLM`` parameters → HF checkpoint
    names."""
    return ModelStateMapperParallel(
        _embed_head_to_hf(tie_word_embeddings=tie_word_embeddings,
                          include_embed=include_embed,
                          include_head=include_head)
        + _dense_layers(config, layers))


def _moe_layers(config, layers, experts_format, to_hf: bool):
    if experts_format not in _EXPERTS_FORMATS:
        raise ValueError(f"unknown experts_format {experts_format!r}")
    out: list[ModelStateMapper] = []
    for i in layers if layers is not None else range(config.num_layers):
        hf, us = f"model.layers.{i}.mlp", f"model.layers.{i}.mlp"
        out += [_same(n) for n in _attention_names(config, i, gate=False,
                                                   sinks=False)]
        if i in config.mlp_only_layers:
            out += [_same(n) for n in _dense_mlp_names(i)]
            continue
        pair = (f"{us}.router.gate.weight", f"{hf}.gate.weight")
        out.append(ModelStateMapperRename(*(pair if to_hf else pair[::-1])))
        stacks = {p: f"{us}.grouped_experts.{p}"
                  for p in ("gate_proj", "up_proj", "down_proj")}
        if experts_format == "fused":
            gate_up, down = (f"{hf}.experts.gate_up_proj",
                             f"{hf}.experts.down_proj")
            if to_hf:
                out += [_FusedExpertsToHF(stacks["gate_proj"],
                                          stacks["up_proj"], gate_up),
                        _TransposedRenameLast2(stacks["down_proj"], down)]
            else:
                out += [_FusedExpertsFromHF(gate_up, stacks["gate_proj"],
                                            stacks["up_proj"]),
                        _TransposedRenameLast2(down, stacks["down_proj"])]
            continue
        for proj, stack in stacks.items():
            each = [f"{hf}.experts.{e}.{proj}.weight"
                    for e in range(config.num_experts)]
            out.append(_UnstackExpertsTransposed(stack, each) if to_hf
                       else _StackExpertsTransposed(each, stack))
    return out


def qwen3_moe_from_hf_mapper(config, *, tie_word_embeddings: bool = False,
                             layers: list[int] | None = None,
                             include_embed: bool = True,
                             include_head: bool = True,
                             experts_format: str = "module_list"
                             ) -> ModelStateMapper:
    """HF Qwen3MoE checkpoint names → the port's ``Qwen3MoeCausalLM``
    parameters; ``experts_format``: ``"module_list"`` (transformers v4)
    or ``"fused"`` (v5)."""
    layer_mappers = _moe_layers(config, layers, experts_format, to_hf=False)
    return ModelStateMapperParallel(
        _embed_head_from_hf(tie_word_embeddings=tie_word_embeddings,
                            include_embed=include_embed,
                            include_head=include_head) + layer_mappers)


def qwen3_moe_to_hf_mapper(config, *, tie_word_embeddings: bool = False,
                           layers: list[int] | None = None,
                           include_embed: bool = True,
                           include_head: bool = True,
                           experts_format: str = "module_list"
                           ) -> ModelStateMapper:
    """The port's ``Qwen3MoeCausalLM`` parameters → HF Qwen3MoE checkpoint
    names (``experts_format``: see :func:`qwen3_moe_from_hf_mapper`)."""
    layer_mappers = _moe_layers(config, layers, experts_format, to_hf=True)
    return ModelStateMapperParallel(
        _embed_head_to_hf(tie_word_embeddings=tie_word_embeddings,
                          include_embed=include_embed,
                          include_head=include_head) + layer_mappers)


__all__ = ["qwen3_dense_from_hf_mapper", "qwen3_dense_to_hf_mapper",
           "qwen3_moe_from_hf_mapper", "qwen3_moe_to_hf_mapper"]
