"""Logical axis vocabulary for parameter partitioning (counterpart of
``d9d_tpu/nn/logical_axes.py``), and each parameter's logical axes in the
port's own layout.

The JAX package annotates every parameter with logical axis names where it
defines it; a parallelism plan maps names to mesh axes
(``parallel/plan.py``). The port keeps the names and gives each module that
owns parameters their axes:

- a :class:`~d9d_tpu_torch.nn.linear.Projection` holds a flax ``Dense``
  kernel ``[in, out]`` transposed, as ``weight [out, in]``; it carries the
  kernel's flax axes (``flax_axes``), and its weight's axes are those
  reversed;
- any other module lists its parameters' axes in ``logical_axes()``, in
  the layout it holds them (the same as flax's: vocab tables, norms,
  sinks, expert stacks).

:func:`param_layouts` is the one table of both facts: the loader of JAX
weights (``model_state/from_jax.py``) transposes exactly the parameters it
marks ``transposed``, and the plans read its axes.
"""

import dataclasses

from torch import nn

# Embedding / residual stream width.
EMBED = "embed"
# Vocabulary dimension.
VOCAB = "vocab"
# Feature dim of vocab-range tables (embedding + LM head): distinct from
# EMBED so ZeRO-3 plans shard these tables on their vocab dim instead.
VOCAB_FEATURES = "vocab_features"
# FFN intermediate width.
MLP = "mlp"
# Attention query heads (x head_dim fused projections are split on heads).
HEADS = "heads"
# Attention kv heads.
KV_HEADS = "kv_heads"
# Per-head feature dim.
HEAD_DIM = "head_dim"
# Expert index dim of MoE grouped weights.
EXPERT = "expert"
# In/out feature dims of grouped expert weights.
EXPERT_EMBED = "expert_embed"
EXPERT_MLP = "expert_mlp"
# Classification classes.
CLASSES = "classes"

Axes = tuple["str | None", ...]


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """A parameter's logical axes in the port's layout, and whether it is
    a flax ``Dense`` kernel held transposed."""

    axes: Axes
    transposed: bool = False


def param_layouts(model: nn.Module) -> dict[str, ParamLayout]:
    """``{parameter name: ParamLayout}`` for every parameter of ``model``;
    raises on a parameter whose module gives it no axes."""
    out: dict[str, ParamLayout] = {}
    for mod_name, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        flax_axes = getattr(mod, "flax_axes", None)
        if flax_axes is not None:
            table = {"weight": ParamLayout(tuple(reversed(flax_axes)), True)}
        elif hasattr(mod, "logical_axes"):
            table = {k: ParamLayout(tuple(v))
                     for k, v in mod.logical_axes().items()}
        else:
            table = {}
        for leaf, p in own.items():
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if leaf not in table:
                raise KeyError(f"parameter {name} has no logical axes")
            if len(table[leaf].axes) != p.dim():
                raise ValueError(
                    f"parameter {name}: axes {table[leaf].axes} for a "
                    f"{p.dim()}-dim tensor")
            out[name] = table[leaf]
    return out
