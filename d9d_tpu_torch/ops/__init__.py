from d9d_tpu_torch.ops.attention.eager import eager_sdpa
from d9d_tpu_torch.ops.linear_ce import LM_IGNORE_INDEX, linear_cross_entropy
from d9d_tpu_torch.ops.moe import (
    TokenSort,
    combine_pairs,
    gate_up_grouped_matmul,
    grouped_matmul,
    permute_tokens,
    sort_tokens_by_expert,
    stable_expert_order,
    unpermute_combine,
)
from d9d_tpu_torch.ops.moe_ffn import (
    AlignedMeta,
    aligned_metadata,
    fused_moe_ffn_apply,
)
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
from d9d_tpu_torch.ops.stochastic import fold_seed, stochastic_round_to_bf16
from d9d_tpu_torch.ops.swiglu import silu_mul, swiglu

__all__ = [
    "AlignedMeta",
    "TokenSort",
    "aligned_metadata",
    "combine_pairs",
    "fused_moe_ffn_apply",
    "gate_up_grouped_matmul",
    "grouped_matmul",
    "permute_tokens",
    "sort_tokens_by_expert",
    "stable_expert_order",
    "unpermute_combine",
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
    "fold_seed",
    "stochastic_round_to_bf16",
    "silu_mul",
    "swiglu",
]
