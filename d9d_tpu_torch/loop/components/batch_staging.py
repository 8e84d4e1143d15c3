"""Host batch → device microbatches (counterpart of
``d9d_tpu/loop/components/batch_staging.py``).

:func:`split_microbatches` cuts a prepared global batch into a list of
microbatches; :func:`stage_microbatches` does that and moves every leaf to
the device (from pinned memory, asynchronously, on a CUDA device). One
device: there is no data-parallel sharding to place.
"""

import numpy as np
import torch


def split_microbatches(prepared: dict, *, num_microbatches: int,
                       microbatch_size: int) -> list[dict]:
    """Host-side: ``{name: [n*m, ...]}`` → ``n`` dicts of ``[m, ...]``."""
    n, m = num_microbatches, microbatch_size
    stacked = {}
    for key, x in prepared.items():
        x = np.asarray(x)
        if x.shape[0] != n * m:
            raise ValueError(
                f"batch leading dim {x.shape[0]} != global batch {n * m}")
        stacked[key] = x.reshape(n, m, *x.shape[1:])
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def stage_microbatches(prepared: dict, *, num_microbatches: int,
                       microbatch_size: int,
                       device: torch.device) -> list[dict[str, torch.Tensor]]:
    """:func:`split_microbatches`, each leaf as a tensor on ``device``."""
    out = []
    for mb in split_microbatches(prepared, num_microbatches=num_microbatches,
                                 microbatch_size=microbatch_size):
        staged = {}
        for key, x in mb.items():
            t = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            staged[key] = t
        out.append(staged)
    return out
