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
    """Flash-attention kernels (``ops/attention/flash.py``): the CUDA
    kernels for CUDA tensors, their plain versions for CPU tensors.
    ``fused_bwd`` selects the one-pass backward kernel over the split
    dq / dk-dv pair."""

    type: str = "flash"
    fused_bwd: bool = False


@dataclasses.dataclass(frozen=True)
class SdpaRingConfig:
    """Ring attention over the context-parallel mesh axis
    (``ops/attention/ring.py``). Requires the model's sequence dim cut over
    ``seq_axis`` (the batch stager does it, over ``cp_s`` only: any other
    ``seq_axis`` raises) and the factory's ``ctx``. Under data
    parallelism each rank's rows ring over its own ``cp_s`` group, under
    tensor parallelism each rank's head slice (``head_axes``: ``tp``; other
    head axes larger than 1 raise)."""

    type: str = "ring"
    seq_axis: str = "cp_s"
    batch_axes: tuple[str, ...] = ("dp_r", "dp_s")
    head_axes: tuple[str, ...] = ("tp",)


SdpaBackendConfig = Union[SdpaEagerConfig, SdpaFlashConfig, SdpaRingConfig]
