"""RMS normalization op (counterpart of ``d9d_tpu/ops/rms_norm.py``).

The reduction runs in float32 regardless of the input dtype and the result
is cast back at the end, exactly as the JAX op does. Plain PyTorch: the JAX
package leaves this op to XLA, so no hand-written kernel stands behind it;
the normalization itself is PyTorch's own ``rms_norm`` on the widened input
(one pass instead of a chain of elementwise launches).
"""

import torch
import torch.nn.functional as F


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
    zero_centered: bool = False,
) -> torch.Tensor:
    """Normalize ``x`` over its last dim and scale by ``weight``.

    With ``zero_centered=True`` the effective scale is ``1 + weight`` (the
    parameter is stored as an offset from 1).
    """
    scale = weight.float()
    if zero_centered:
        scale = scale + 1.0
    return F.rms_norm(x.float(), (x.shape[-1],), scale, eps).to(x.dtype)
