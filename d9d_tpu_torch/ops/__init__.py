from d9d_tpu_torch.ops.attention.eager import eager_sdpa
from d9d_tpu_torch.ops.linear_ce import LM_IGNORE_INDEX, linear_cross_entropy
from d9d_tpu_torch.ops.rms_norm import rms_norm
from d9d_tpu_torch.ops.rope import (
    RopeScaling,
    RopeScalingLinear,
    RopeScalingLlama3,
    RopeScalingNone,
    RopeScalingNtk,
    RopeScalingYarn,
    RopeStyle,
    apply_rope,
    compute_rope_frequencies,
    make_rope_cos_sin,
)
from d9d_tpu_torch.ops.swiglu import silu_mul, swiglu

__all__ = [
    "LM_IGNORE_INDEX",
    "eager_sdpa",
    "linear_cross_entropy",
    "rms_norm",
    "RopeScaling",
    "RopeScalingLinear",
    "RopeScalingLlama3",
    "RopeScalingNone",
    "RopeScalingNtk",
    "RopeScalingYarn",
    "RopeStyle",
    "apply_rope",
    "compute_rope_frequencies",
    "make_rope_cos_sin",
    "silu_mul",
    "swiglu",
]
