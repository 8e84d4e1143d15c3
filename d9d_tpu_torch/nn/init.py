"""Parameter initializers of the JAX package, drawn with PyTorch generators.

The draws cannot repeat flax's random bits (``jax.random`` and
``torch.Generator`` differ), but they follow the same distributions, so a
model initialized from a seed in the port is a sample of the model the JAX
package would initialize.

Each initializer draws the parameter's whole value (its global shape, for
a parameter that ``fully_shard`` has sharded) from the generator and
writes this rank's piece of it (``parallel/shards.py``): a sharded build
consumes the generator's stream exactly as the one-process build does, so
its pieces are those of the one-process parameters, bit for bit, and never
more than one parameter is held whole.
"""

import torch

from d9d_tpu_torch.parallel.shards import write_whole_

# standard deviation of a standard normal truncated to [-2, 2]; flax divides
# by it so that the truncated draw has the variance it asks for
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_draw_(
    draw: torch.Tensor,
    fan_in: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``flax.linen.initializers.lecun_normal()`` into the fp32 tensor
    ``draw``: a normal truncated at two of its standard deviations, scaled
    to variance ``1 / fan_in`` — i.e. ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    return torch.nn.init.trunc_normal_(
        draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(
    weight: torch.Tensor,
    fan_in: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """:func:`lecun_normal_draw_` for ``weight``, drawn in fp32 and
    rounded into the parameter's dtype."""
    draw = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    write_whole_(weight, lecun_normal_draw_(draw, fan_in, generator))
    return weight


def variance_scaling_uniform_(
    weight: torch.Tensor,
    scale: float,
    fan_in: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``variance_scaling(scale, "fan_in", "uniform")`` in place: uniform
    on ``[-b, b]`` with ``b = sqrt(3 * scale / fan_in)``, i.e. variance
    ``scale / fan_in``. flax counts every axis that is neither ``in_axis``
    nor ``out_axis`` as receptive field, so for the expert stacks
    ``[E, in, out]`` (``in_axis=1, out_axis=2``) the fan-in is ``E * in``.
    Drawn in fp32, rounded into the parameter's dtype."""
    bound = (3.0 * scale / fan_in) ** 0.5
    draw = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    draw.uniform_(-bound, bound, generator=generator)
    write_whole_(weight, draw)
    return weight
