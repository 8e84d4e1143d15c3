"""SDPA backend configs (counterpart of ``d9d_tpu/nn/sdpa/config.py``).

Plain frozen dataclasses with a ``type`` tag. There is no environment
override: which path a call takes inside a backend is decided by the
device its tensors lie on and nothing else.
"""

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class SdpaEagerConfig:
    """Plain PyTorch attention. Full feature surface; the correctness
    oracle."""

    type: str = "eager"


@dataclasses.dataclass(frozen=True)
class SdpaFlashConfig:
    """Flash-attention forward kernel (``ops/attention/flash.py``): the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""

    type: str = "flash"


@dataclasses.dataclass(frozen=True)
class SdpaRingConfig:
    """Ring attention over a context-parallel axis — not ported yet."""

    type: str = "ring"


SdpaBackendConfig = Union[SdpaEagerConfig, SdpaFlashConfig, SdpaRingConfig]
