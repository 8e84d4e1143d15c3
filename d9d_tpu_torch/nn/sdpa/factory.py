"""SDPA backend factory (counterpart of ``d9d_tpu/nn/sdpa/factory.py``).

``None`` builds the flash backend — the serving default. No auto-detection
of the platform and no environment override: the flash backend itself takes
its CUDA kernel for CUDA tensors and its plain version for CPU tensors.
"""

from d9d_tpu_torch.nn.sdpa.config import (
    SdpaBackendConfig,
    SdpaEagerConfig,
    SdpaFlashConfig,
    SdpaRingConfig,
)
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend


def build_sdpa_backend(config: SdpaBackendConfig | None = None) -> SdpaBackend:
    if config is None:
        config = SdpaFlashConfig()
    if isinstance(config, SdpaEagerConfig):
        from d9d_tpu_torch.ops.attention.eager import eager_sdpa

        return eager_sdpa
    if isinstance(config, SdpaFlashConfig):
        from d9d_tpu_torch.ops.attention.flash import make_flash_sdpa

        return make_flash_sdpa(fused_bwd=config.fused_bwd)
    if isinstance(config, SdpaRingConfig):
        raise NotImplementedError(
            "the ring (context-parallel) SDPA backend is not ported yet"
        )
    raise TypeError(f"unknown sdpa config: {config!r}")
