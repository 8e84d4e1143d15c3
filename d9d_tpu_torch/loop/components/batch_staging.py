"""Host batch → device microbatches (counterpart of
``d9d_tpu/loop/components/batch_staging.py``).

:func:`split_microbatches` cuts a prepared global batch into a list of
microbatches; :func:`stage_microbatches` does that and moves every leaf to
the device (from pinned memory, asynchronously, on a CUDA device). Every
rank reads the same global batch and keeps its own part of each
microbatch, the layout of the JAX package's ``batch_sharding`` (batch dim
over ``dp_r x dp_s``, sequence dim over ``cp_s``):

- data parallelism: rank ``c`` of ``dp`` (its row-major coordinate on
  ``(dp_r, dp_s)``) keeps rows ``[c·m/dp, (c+1)·m/dp)`` of every leaf of
  each microbatch of ``m`` rows;
- context parallelism: rank ``i`` of ``cp`` then keeps positions
  ``[i·seq_len/cp, (i+1)·seq_len/cp)`` of every leaf whose dim 2 (after
  microbatch stacking) equals ``seq_len``. Other leaves keep their
  sequence dim whole. Positions are made before the cut
  (``CausalLMTask.prepare_batch``), so each chunk carries its global rope
  positions; labels are shifted before it, so no target is lost at a chunk
  boundary.
"""

import numpy as np
import torch


def check_cp_seq_len(seq_len: int | None, cp_size: int) -> None:
    """``seq_len`` must split evenly over the context-parallel ranks."""
    if cp_size > 1 and (seq_len is None or seq_len % cp_size != 0):
        raise ValueError(
            f"seq_len {seq_len} not divisible by the context-parallel axis "
            f"size {cp_size}; no leaf could ever be sequence-sharded")


def split_microbatches(prepared: dict, *, num_microbatches: int,
                       microbatch_size: int, seq_len: int | None = None,
                       cp_size: int = 1, cp_rank: int = 0, dp_size: int = 1,
                       dp_rank: int = 0) -> list[dict]:
    """Host-side: ``{name: [n*m, ...]}`` → ``n`` dicts of ``[m/dp, ...]``,
    each this dp rank's rows and each sequence leaf cut to this cp rank's
    chunk."""
    check_cp_seq_len(seq_len, cp_size)
    n, m = num_microbatches, microbatch_size
    if m % dp_size != 0:
        raise ValueError(
            f"microbatch_size {m} not divisible by dp_size {dp_size}")
    m_loc = m // dp_size
    stacked = {}
    for key, x in prepared.items():
        x = np.asarray(x)
        if x.shape[0] != n * m:
            raise ValueError(
                f"batch leading dim {x.shape[0]} != global batch {n * m}")
        x = x.reshape(n, m, *x.shape[1:])
        x = x[:, dp_rank * m_loc:(dp_rank + 1) * m_loc]
        if cp_size > 1 and x.ndim >= 3 and x.shape[2] == seq_len:
            t_loc = seq_len // cp_size
            x = x[:, :, cp_rank * t_loc:(cp_rank + 1) * t_loc]
        stacked[key] = x
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def stage_microbatches(prepared: dict, *, num_microbatches: int,
                       microbatch_size: int, device: torch.device,
                       seq_len: int | None = None, cp_size: int = 1,
                       cp_rank: int = 0, dp_size: int = 1,
                       dp_rank: int = 0) -> list[dict[str, torch.Tensor]]:
    """:func:`split_microbatches`, each leaf as a tensor on ``device``."""
    out = []
    for mb in split_microbatches(prepared, num_microbatches=num_microbatches,
                                 microbatch_size=microbatch_size,
                                 seq_len=seq_len, cp_size=cp_size,
                                 cp_rank=cp_rank, dp_size=dp_size,
                                 dp_rank=dp_rank):
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
