"""Qwen3-dense model family configuration (counterpart of
``d9d_tpu/models/qwen3/config.py``). Frozen dataclass with the JAX
config's fields and defaults."""

import dataclasses

from d9d_tpu_torch.ops import RopeScaling, RopeScalingNone


@dataclasses.dataclass(frozen=True)
class Qwen3DenseConfig:
    vocab_ranges: tuple[tuple[str, int], ...]
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rope_scaling: RopeScaling = RopeScalingNone()
    qk_norm: bool = True
    norm_eps: float = 1e-6
    window_size: int | None = None
    use_sinks: bool = False
    use_output_gate: bool = False
    # single matmul for q/k/v (runtime weight concat; nn/attention.py)
    fused_qkv: bool = False
    # recompute each decoder layer in the backward (training only); the
    # port has the "full" policy — every other policy name raises
    remat: bool = True
    remat_policy: str = "full"

    @property
    def vocab_size(self) -> int:
        return sum(s for _, s in self.vocab_ranges)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "Qwen3DenseConfig":
        """2-layer CPU-runnable config."""
        return Qwen3DenseConfig(
            vocab_ranges=(("default", vocab_size),),
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            remat=False,
        )

    @staticmethod
    def qwen3_8b(vocab_size: int = 151_936) -> "Qwen3DenseConfig":
        return Qwen3DenseConfig(
            vocab_ranges=(("default", vocab_size),),
            hidden_size=4096,
            num_layers=36,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=12_288,
        )
