"""Parameter initializers of the JAX package, drawn with PyTorch generators.

The draws cannot repeat flax's random bits (``jax.random`` and
``torch.Generator`` differ), but they follow the same distributions, so a
model initialized from a seed in the port is a sample of the model the JAX
package would initialize.
"""

import torch

# standard deviation of a standard normal truncated to [-2, 2]; flax divides
# by it so that the truncated draw has the variance it asks for
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(
    weight: torch.Tensor,
    fan_in: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``flax.linen.initializers.lecun_normal()`` in place: a normal
    truncated at two of its standard deviations, scaled to variance
    ``1 / fan_in`` — i.e. ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``. The draw is made in fp32 and rounded into the
    parameter's dtype."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    draw = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    torch.nn.init.trunc_normal_(
        draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(draw)
    return weight
