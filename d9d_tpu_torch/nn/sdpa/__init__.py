from d9d_tpu_torch.nn.sdpa.config import (
    SdpaBackendConfig,
    SdpaEagerConfig,
    SdpaFlashConfig,
    SdpaRingConfig,
)
from d9d_tpu_torch.nn.sdpa.factory import build_sdpa_backend
from d9d_tpu_torch.nn.sdpa.protocol import SdpaBackend

__all__ = [
    "SdpaBackend",
    "SdpaBackendConfig",
    "SdpaEagerConfig",
    "SdpaFlashConfig",
    "SdpaRingConfig",
    "build_sdpa_backend",
]
