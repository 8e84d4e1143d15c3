"""The process group of a multi-process run (counterpart of
``d9d_tpu/core/distributed.py`` ``init_distributed`` /
``shutdown_distributed``).

The JAX package starts its runtime from a coordinator address that it may
read from the environment. The port reads nothing around it: the caller
names the rendezvous (``init_method``, e.g. ``"tcp://localhost:29500"`` or
``"file:///tmp/rdzv"``), its ``rank``, the ``world_size`` and the
``backend`` — ``"nccl"`` with one card per rank, ``"gloo"`` where ranks
share a card or run on the CPU. A ring or a reduction over a gloo group
stages device tensors through host memory (``core/collectives.py``,
``ops/attention/ring.py``): the backend decides that, nothing else does.
"""

import contextlib
import datetime

import torch.distributed as dist

_owns_group = False


def init_distributed(
    *,
    rank: int,
    world_size: int,
    init_method: str | None = None,
    backend: str = "nccl",
    timeout_s: float = 300.0,
) -> bool:
    """Start the default process group. Returns True when this call started
    it; False for one process (nothing to start) and when a group already
    exists (idempotent: a second call, or a launcher's own group, is left
    as it is — its world size must agree)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group is already up as rank {dist.get_rank()} "
                f"of {dist.get_world_size()}, not {rank} of {world_size}")
        return False
    if world_size == 1:
        return False
    if init_method is None:
        raise ValueError(
            "init_distributed: a multi-process run needs its rendezvous "
            "(init_method='tcp://host:port' or 'file:///path')")
    global _owns_group
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    _owns_group = True
    return True


def shutdown_distributed() -> None:
    """Destroy the default process group, only if :func:`init_distributed`
    started it (a launcher's group belongs to the launcher)."""
    global _owns_group
    if _owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _owns_group = False


@contextlib.contextmanager
def main_process_first():
    """Rank 0 runs the body first; the other ranks wait at a barrier, then
    run it (the rank-0-first pattern for a download or a cache one process
    should fill before the rest read it). One process: a plain
    passthrough."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        yield
        return
    if dist.get_rank() == 0:
        try:
            yield
        finally:
            dist.barrier()
    else:
        dist.barrier()
        yield


__all__ = ["init_distributed", "main_process_first", "shutdown_distributed"]
