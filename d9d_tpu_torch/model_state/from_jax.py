"""Carry the JAX package's weights across into the port's modules.

``load_jax_params(model, flat)`` takes the flax parameter tree of the JAX
model FLATTENED BY THE CALLER to ``{"model/layers_0/self_attn/q_proj/kernel":
np.ndarray, ...}`` (path components joined with ``/``) and fills the
parameters of the port's counterpart module (a whole
``Qwen3DenseCausalLM`` or any block of it):

- a Dense ``kernel [in, out]`` becomes a ``weight [out, in]`` (transposed);
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
the model that got no value. This module imports numpy and torch only.
"""

import numpy as np
import torch

from d9d_tpu_torch.nn.embedding import TokenEmbedding
from d9d_tpu_torch.nn.heads import LanguageModellingHead
from d9d_tpu_torch.nn.vocab_ranges import (
    concat_vocab_ranges,
    vocab_range_names,
)


def _to_tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(
        device=like.device, dtype=like.dtype
    )


def load_jax_params(model, flat: dict) -> None:
    """Fill ``model``'s parameters in place from a flattened flax tree."""
    remaining = dict(flat)
    if remaining and all(k.startswith("params/") for k in remaining):
        remaining = {k[len("params/"):]: v for k, v in remaining.items()}
    loaded: set[str] = set()
    params = dict(model.named_parameters())

    def assign(name: str, value: torch.Tensor) -> None:
        target = params[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"shape mismatch for {name}: source {tuple(value.shape)}, "
                f"parameter {tuple(target.shape)}"
            )
        with torch.no_grad():
            target.copy_(value)
        loaded.add(name)

    def take(key: str):
        if key not in remaining:
            raise KeyError(f"missing key in the flax tree: {key}")
        return remaining.pop(key)

    # vocabulary tables: concat the named ranges once, in range order
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
        tables = [
            _to_tensor(take(f"{scope}/{leaf}" if scope else leaf), params[name])
            for leaf in vocab_range_names(prefix, mod.vocab_ranges)
        ]
        assign(name, concat_vocab_ranges(tables))

    for key in list(remaining):
        parts = key.split("/")
        leaf = parts[-1]
        mods = [
            f"layers.{p[len('layers_'):]}" if p.startswith("layers_") else p
            for p in parts[:-1]
        ]
        if leaf == "kernel":
            name = ".".join(mods + ["weight"])
            if name not in params:
                continue  # reported below as left over
            value = _to_tensor(remaining.pop(key), params[name]).T
        else:
            name = ".".join(mods + [leaf])
            if name not in params:
                continue
            value = _to_tensor(remaining.pop(key), params[name])
        assign(name, value)

    if remaining:
        raise KeyError(
            f"keys of the flax tree with no parameter in the model: "
            f"{sorted(remaining)}"
        )
    missing = sorted(set(params) - loaded)
    if missing:
        raise KeyError(f"model parameters that got no value: {missing}")
