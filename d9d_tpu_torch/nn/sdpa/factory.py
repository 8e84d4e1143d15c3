"""SDPA backend factory (counterpart of ``d9d_tpu/nn/sdpa/factory.py``).

``None`` builds the flash backend — the serving default. No auto-detection
of the platform and no environment override: the flash backend itself takes
its CUDA kernel for CUDA tensors and its plain version for CPU tensors.
The port has no ambient mesh: the ring backend is built over the
``MeshContext`` passed as ``ctx``.
"""

from d9d_tpu_torch.nn.sdpa.config import (
    SdpaBackendConfig,
    SdpaEagerConfig,
    SdpaFlashConfig,
    SdpaRingConfig,
)
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend


def build_sdpa_backend(config: SdpaBackendConfig | None = None, *,
                       ctx=None) -> SdpaBackend:
    if config is None:
        config = SdpaFlashConfig()
    if isinstance(config, SdpaEagerConfig):
        from d9d_tpu_torch.ops.attention.eager import eager_sdpa

        return eager_sdpa
    if isinstance(config, SdpaFlashConfig):
        from d9d_tpu_torch.ops.attention.flash import make_flash_sdpa

        return make_flash_sdpa(fused_bwd=config.fused_bwd)
    if isinstance(config, SdpaRingConfig):
        from d9d_tpu_torch.ops.attention.ring import make_ring_sdpa

        if ctx is None:
            raise ValueError(
                "the ring sdpa backend needs the mesh: "
                "build_sdpa_backend(SdpaRingConfig(...), ctx=mesh_context)")
        return make_ring_sdpa(
            ctx, seq_axis=config.seq_axis, batch_axes=config.batch_axes,
            head_axes=config.head_axes)
    raise TypeError(f"unknown sdpa config: {config!r}")
