"""Rotary position embeddings: frequency computation, scaling laws,
application (counterpart of ``d9d_tpu/ops/rope.py``).

Two layout styles (HALF = GPT-NeoX rotate-half, INTERLEAVED = GPT-J pairs)
and the five scaling laws of the JAX module. All functions are pure
functions of static config plus a positions tensor; angles are computed in
float32.
"""

import dataclasses
import enum
import math

import torch


class RopeStyle(enum.Enum):
    HALF = "half"
    INTERLEAVED = "interleaved"


@dataclasses.dataclass(frozen=True)
class RopeScalingNone:
    pass


@dataclasses.dataclass(frozen=True)
class RopeScalingLinear:
    factor: float


@dataclasses.dataclass(frozen=True)
class RopeScalingNtk:
    """NTK-aware scaling: rescales theta so the longest wavelength covers
    the extended context."""

    factor: float


@dataclasses.dataclass(frozen=True)
class RopeScalingYarn:
    """YaRN (arXiv 2309.00071): interpolate low-frequency bands, extrapolate
    high-frequency bands, with sqrt-log attention temperature."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float | None = None


@dataclasses.dataclass(frozen=True)
class RopeScalingLlama3:
    """Llama-3.1 piecewise scaling: wavelengths longer than the original
    context are interpolated by ``factor``, shorter than
    ``original_max_position / high_freq_factor`` are kept, and the band
    between is linearly blended."""

    factor: float
    original_max_position: int
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0

    def __post_init__(self):
        if self.low_freq_factor >= self.high_freq_factor:
            raise ValueError(
                f"llama3 rope scaling needs low_freq_factor "
                f"({self.low_freq_factor}) < high_freq_factor "
                f"({self.high_freq_factor}) — the blend-band denominator "
                f"is their difference"
            )


RopeScaling = (
    RopeScalingNone | RopeScalingLinear | RopeScalingNtk | RopeScalingYarn
    | RopeScalingLlama3
)


def _yarn_correction_dim(
    num_rotations: float, dim: int, theta: float, max_pos: int
) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(theta)
    )


def compute_rope_frequencies(
    head_dim: int,
    theta: float,
    scaling: RopeScaling = RopeScalingNone(),
    *,
    device: "torch.device | str | None" = "cpu",
) -> tuple[torch.Tensor, float]:
    """Return ``(inv_freq [head_dim//2] float32, attention_scale)``.

    ``attention_scale`` multiplies cos/sin (YaRN temperature); 1.0
    otherwise. The table is tiny, so it is built on ``device`` directly
    (default CPU; models pass their own device).
    """
    dim = head_dim
    exponents = (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    )
    inv_freq = 1.0 / (theta**exponents)
    scale = 1.0

    if isinstance(scaling, RopeScalingNone):
        pass
    elif isinstance(scaling, RopeScalingLinear):
        inv_freq = inv_freq / scaling.factor
    elif isinstance(scaling, RopeScalingNtk):
        adjusted_theta = theta * scaling.factor ** (dim / (dim - 2))
        inv_freq = 1.0 / (adjusted_theta**exponents)
    elif isinstance(scaling, RopeScalingYarn):
        low = _yarn_correction_dim(
            scaling.beta_fast, dim, theta, scaling.original_max_position
        )
        high = _yarn_correction_dim(
            scaling.beta_slow, dim, theta, scaling.original_max_position
        )
        low = max(math.floor(low), 0)
        high = min(math.ceil(high), dim // 2 - 1)
        # ramp: 0 where extrapolation (high freq), 1 where interpolation
        ramp = torch.clamp(
            (torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3),
            0.0,
            1.0,
        )
        interp = inv_freq / scaling.factor
        inv_freq = inv_freq * (1 - ramp) + interp * ramp
        if scaling.attention_factor is not None:
            scale = scaling.attention_factor
        else:
            scale = 0.1 * math.log(scaling.factor) + 1.0
    elif isinstance(scaling, RopeScalingLlama3):
        wavelen = 2 * math.pi / inv_freq
        low_wl = scaling.original_max_position / scaling.low_freq_factor
        high_wl = scaling.original_max_position / scaling.high_freq_factor
        smooth = (
            scaling.original_max_position / wavelen - scaling.low_freq_factor
        ) / (scaling.high_freq_factor - scaling.low_freq_factor)
        blended = (1 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wl,
            inv_freq / scaling.factor,
            torch.where(wavelen < high_wl, inv_freq, blended),
        )
    else:
        raise TypeError(f"unknown rope scaling: {scaling!r}")
    return inv_freq, scale


def make_rope_cos_sin(
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    attention_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape ``positions.shape + (head_dim//2,)``."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(angles) * attention_scale
    sin = torch.sin(angles) * attention_scale
    return cos.to(dtype), sin.to(dtype)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    style: RopeStyle = RopeStyle.HALF,
) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by cos/sin ``[..., T, D//2]``.

    HALF pairs element i with i + D/2 (GPT-NeoX / HF Llama layout);
    INTERLEAVED pairs 2i with 2i+1 (GPT-J layout). Math in float32, result
    in ``x``'s dtype.
    """
    d_half = x.shape[-1] // 2
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    xf = x.float()
    if style == RopeStyle.HALF:
        x1 = xf[..., :d_half]
        x2 = xf[..., d_half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    elif style == RopeStyle.INTERLEAVED:
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.stack([r1, r2], dim=-1).reshape(xf.shape)
    else:
        raise ValueError(f"unknown rope style: {style}")
    return out.to(x.dtype)
