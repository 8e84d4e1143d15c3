from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.core.distributed import (
    init_distributed,
    shutdown_distributed,
)
from d9d_tpu_torch.core.mesh import MeshContext, MeshParameters

__all__ = ["MeshContext", "MeshParameters", "init_distributed",
           "resolve_device", "shutdown_distributed"]
