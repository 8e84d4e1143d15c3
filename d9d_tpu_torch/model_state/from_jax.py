"""Carry the JAX package's weights across into the port's modules.

``load_jax_params(model, flat)`` takes the flax parameter tree of the JAX
model FLATTENED BY THE CALLER to ``{"model/layers_0/self_attn/q_proj/kernel":
np.ndarray, ...}`` (path components joined with ``/``) and fills the
parameters of the port's counterpart module (a whole
``Qwen3DenseCausalLM`` or any block of it):

- a Dense ``kernel [in, out]`` becomes a ``weight [out, in]`` (transposed)
  — the MoE router's ``gate`` and the shared expert's projections too;
- the expert stacks ``gate_proj``, ``up_proj`` ``[E, in, out]`` and
  ``down_proj [E, inter, hidden]`` of a ``grouped_experts`` block are parameters
  of their own (not Dense kernels) and are copied as they are;
- the per-range vocabulary tables (``embedding_<range>`` / ``head_<range>``)
  are concatenated in range order into the single table the port holds
  (``nn/vocab_ranges.py``);
- ``layers_<i>`` maps to ``layers.<i>``;
- norm weights and sinks are copied as they are;
- a leading ``params/`` (the variable collection of a JAX ``Trainer``'s
  ``trainer.params``) is dropped, so a JAX training run's fp32 parameters
  load as they are into the port's trainable modules, in the parameters'
  own dtype.

It raises on any key of ``flat`` that is left over and on any parameter of
the model that got no value. Pipeline stages: a stage module keeps the
whole model's names, so JAX's per-stage tree (as its
``PipelineTrainEngine.stages[s].params`` holds it) loads into the port's
stage module as it is; :func:`stage_keys` picks a stage's keys out of a
whole model's tree and :func:`load_jax_stage_params` fills every stage. Which parameters are transposed flax kernels
is read from the one table of parameter layouts
(``nn/logical_axes.py`` ``param_layouts``). A model that a plan sharded
(``parallel/plan.py``) takes only this rank's piece of each sharded
parameter; a model on the meta device (before the sharded init
materializes it) raises, since it has nowhere to keep the values. This
module imports numpy and torch only.

Decode caches are state, not weights: the contiguous slot cache and the
paged serving loop's page pools, int8 scale pools and page table
(``nn/attention.py`` ``DecodeCache`` / ``PagedDecodeCache``) are built
empty by the caller and never carried across. A model served from paged
pools is the same module as one served from a contiguous cache, so the
mapping above covers it unchanged.
"""

import numpy as np
import torch

from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.logical_axes import param_layouts
from d9d_tpu_torch.nn.vocab_ranges import (
    concat_vocab_ranges,
    vocab_range_names,
)
from d9d_tpu_torch.parallel.shards import write_whole_


def _to_tensor(value, like: torch.Tensor) -> torch.Tensor:
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX's comes from ml_dtypes): carry
        # the 16-bit patterns across as they are
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _strip_trainer_prefix(flat: dict) -> dict:
    if flat and all(k.startswith("params/") for k in flat):
        return {k[len("params/"):]: v for k, v in flat.items()}
    return dict(flat)


def jax_param_map(model, keys) -> dict[str, list[str]]:
    """The name mapping of :func:`load_jax_params`: each parameter of
    ``model`` → the keys of the flattened flax tree that fill it (the range
    tables of a vocabulary table in range order, else one key). ``keys``
    may carry the ``params/`` prefix. Raises on a key with no parameter and
    on a parameter with no key."""
    remaining = set(_strip_trainer_prefix(dict.fromkeys(keys)))
    params = dict(model.named_parameters())
    out: dict[str, list[str]] = {}

    def take(key: str) -> str:
        if key not in remaining:
            raise KeyError(f"missing key in the flax tree: {key}")
        remaining.discard(key)
        return key

    # vocabulary tables: the named ranges, in range order
    for mod_name, mod in model.named_modules():
        if isinstance(mod, TokenEmbedding):
            prefix = "embedding"
        elif isinstance(mod, LanguageModellingHead):
            prefix = "head"
        else:
            continue
        name = f"{mod_name}.weight" if mod_name else "weight"
        scope = "/".join(
            f"layers_{p}" if prev == "layers" else p
            for prev, p in zip([""] + mod_name.split("."), mod_name.split("."))
            if p != "layers"
        )
        out[name] = [take(f"{scope}/{leaf}" if scope else leaf)
                     for leaf in vocab_range_names(prefix, mod.vocab_ranges)]

    for key in sorted(remaining):
        parts = key.split("/")
        mods = [
            f"layers.{p[len('layers_'):]}" if p.startswith("layers_") else p
            for p in parts[:-1]
        ]
        leaf = "weight" if parts[-1] == "kernel" else parts[-1]
        name = ".".join(mods + [leaf])
        if name in params and name not in out:
            out[name] = [take(key)]

    if remaining:
        raise KeyError(
            f"keys of the flax tree with no parameter in the model: "
            f"{sorted(remaining)}"
        )
    missing = sorted(set(params) - set(out))
    if missing:
        raise KeyError(f"model parameters that got no value: {missing}")
    return out


def _module_path(key: str) -> str:
    return ".".join(f"layers.{p[len('layers_'):]}" if p.startswith("layers_")
                    else p for p in key.split("/")[:-1])


def stage_keys(model, flat: dict) -> dict:
    """The entries of a whole model's flattened flax tree ``flat`` that
    the parameters of ``model`` (a pipeline stage of it) take."""
    flat = _strip_trainer_prefix(flat)
    paths = {n.rsplit(".", 1)[0] if "." in n else ""
             for n, _ in model.named_parameters()}
    return {k: v for k, v in flat.items() if _module_path(k) in paths}


def load_jax_stage_params(stages: dict, flats: dict) -> None:
    """Fill each stage module (``stages``: stage id → module) from its
    flattened flax tree (``flats``: stage id → JAX's per-stage tree or a
    whole model's, cut by :func:`stage_keys`)."""
    for s, module in stages.items():
        load_jax_params(module, stage_keys(module, flats[s]))


def load_jax_params(model, flat: dict) -> None:
    """Fill ``model``'s parameters in place from a flattened flax tree."""
    flat = _strip_trainer_prefix(flat)
    params = dict(model.named_parameters())
    meta = sorted(n for n, p in params.items() if p.is_meta)
    if meta:
        raise ValueError(
            f"load_jax_params: parameters on the meta device ({meta[:3]}"
            f"...): load after the model is materialized")
    layouts = param_layouts(model)
    for name, keys in jax_param_map(model, flat).items():
        target = params[name]
        if layouts[name].transposed:
            value = _to_tensor(flat[keys[0]], target).T
        else:
            value = concat_vocab_ranges(
                [_to_tensor(flat[k], target) for k in keys])
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"shape mismatch for {name}: source {tuple(value.shape)}, "
                f"parameter {tuple(target.shape)}"
            )
        write_whole_(target, value)
