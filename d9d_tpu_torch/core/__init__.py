from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.core.mesh import MeshContext, MeshParameters

__all__ = ["MeshContext", "MeshParameters", "resolve_device"]
