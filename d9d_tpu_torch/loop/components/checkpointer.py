"""Job-state checkpointing over ``torch.distributed.checkpoint`` (DCP):
``save_{step}`` dirs, rotation, resume-latest (counterpart of
``d9d_tpu/loop/components/checkpointer.py``, which rides orbax).

Directory contract, the JAX package's: ``{dir}/save_{step}/`` with
``num_to_keep`` rotation and resume = latest. A step directory holds

- the arrays (the model's ``state_dict()`` and the optimizer's
  ``checkpoint_state()``: ``DTensor`` pieces where a plan sharded the
  parameters) as DCP writes them: one ``.distcp`` file per rank and the
  ``.metadata`` index;
- ``meta.json``, the host-side state (step, data loader position, tracker
  run hash), which rank 0 writes;
- ``d9d_manifest.json`` (``resilience/manifest.py``): the file inventory
  with checksums and the saving mesh, written by rank 0 after the step is
  finalized.

Atomic finalize. Orbax writes a tmp directory and renames it; DCP writes in
place. So a step is written as ``save_{step}.tmp`` and renamed to
``save_{step}`` by rank 0 once every rank's files are down (DCP's save ends
with a collective through rank 0 that follows every rank's writes). A save
killed mid-way leaves only the tmp directory, which never lists as a step
(and is removed when the step is saved again, or when a checkpointer is
built on the directory).

Async save (``async_save=True``, JAX's default). ``save()`` takes a copy of
every array in host memory first (the staging: the optimizers update
parameters and moments in place, so a write that read them later would
write a later step's bytes), then writes it on a thread of its own and
returns. The next ``save`` / ``wait_until_finished`` / ``restore`` /
``close`` waits for it and finalizes it: rename, manifest, rotation, as
orbax finalizes at its next barrier. Sync saves write the live arrays and
finalize at once. Either way the bytes on disk are the same. DCP's
planning collectives run over a gloo group of the checkpointer's own, so a
write in flight never interleaves with the step's collectives.

Restore walks back as the JAX checkpointer does: the newest finalized
step first; a step without a manifest is tried unverified (counted in
``unverified_restore``, warned about at a limited rate); a step that fails
validation or loading is counted (``checkpoint_fallback``) and skipped;
manifest-confirmed corrupt newer steps are pruned once an older step
restores; ``None`` comes back only when no step exists, and it raises when
steps exist but none restores. An explicit ``step`` keeps strict
semantics. The JAX package counts these in its telemetry registry, which
the port does not have (ROADMAP A11): here they are integer attributes.

Another mesh. A step whose manifest records another saving mesh than the
restore target's loads through DCP's resharding of ``DTensor`` pieces (the
JAX path ``_restore_resharded`` without its HBM budget, which is not
ported: ``TrainerConfig.reshard_hbm_budget_mb`` raises), counted in
``reshard_restores``.
"""

import concurrent.futures
import json
import logging
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException
from torch.distributed.tensor import DTensor

from d9d_tpu_torch.resilience.manifest import (
    CheckpointIntegrityError,
    manifest_mesh,
    topology_mismatch,
    validate_checkpoint_dir,
    write_manifest,
)

logger = logging.getLogger("d9d_tpu_torch.checkpointer")

META_NAME = "meta.json"
_STEP_DIR = re.compile(r"^save_(\d+)$")
_TMP_SUFFIX = ".tmp"

# rate limit of the unverified-restore warning: the counter records every
# occurrence, the log line shows up once per interval per process
_UNVERIFIED_WARN_INTERVAL_S = 300.0
_last_unverified_warn = -float("inf")

_groups: dict[Any, Any] = {}


def _checkpoint_group():
    """The gloo group DCP's collectives run over (``None`` without a
    process group). One per default group, made by every rank together at
    the first checkpointer built on it."""
    if not dist.is_initialized():
        return None
    key = dist.group.WORLD
    if key not in _groups:
        _groups[key] = dist.new_group(backend="gloo")
    return _groups[key]


def _stage(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that the next optimizer step cannot touch (a
    ``DTensor`` stays one, its piece copied)."""
    if isinstance(t, DTensor):
        if t.device.type != "cpu":
            return t.detach().to("cpu")
        return DTensor.from_local(t.to_local().detach().clone(),
                                  t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return t.detach().to("cpu", copy=True)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _note_unverified_restore(step: int) -> None:
    global _last_unverified_warn
    now = time.monotonic()
    if now - _last_unverified_warn >= _UNVERIFIED_WARN_INTERVAL_S:
        _last_unverified_warn = now
        logger.warning(
            "checkpoint step %d has no integrity manifest; attempting "
            "unverified restore (further occurrences counted in "
            "unverified_restore without this warning)", step)


class StateCheckpointer:
    """``save`` / ``restore`` of one job's arrays and meta under
    ``directory``. Every rank of the job builds one and calls every method
    together (they are collective); rank 0 alone writes the meta and the
    manifests, renames and deletes."""

    def __init__(
        self,
        directory: str | Path,
        *,
        save_every_steps: int | None = None,
        num_to_keep: int | None = 3,
        async_save: bool = True,
    ):
        self.directory = Path(directory).absolute()
        self.save_every_steps = save_every_steps
        self.num_to_keep = num_to_keep
        self.async_save = async_save
        self.last_saved_step: int | None = None
        self.checkpoint_fallback = 0
        self.unverified_restore = 0
        self.reshard_restores = 0
        # seconds over the checkpointer's life: the blocking part of the
        # saves, the waits for their writes, the restores (validation
        # included) and their manifest validations
        self.saves = 0
        self.save_seconds = 0.0
        self.wait_seconds = 0.0
        self.restore_seconds = 0.0
        self.validate_seconds = 0.0
        self._group = _checkpoint_group()
        self._rank = dist.get_rank() if dist.is_initialized() else 0
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        # the save in flight: (step, future, mesh block)
        self._pending: tuple[int, concurrent.futures.Future, Any] | None = None
        if self._rank == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
            for stale in self.directory.glob(f"save_*{_TMP_SUFFIX}"):
                shutil.rmtree(stale, ignore_errors=True)
        self._barrier()

    # -- helpers -------------------------------------------------------

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"save_{step}"

    def _tmp_dir(self, step: int) -> Path:
        return self.directory / f"save_{step}{_TMP_SUFFIX}"

    def all_steps(self) -> list[int]:
        """The finalized steps on disk, ascending."""
        if not self.directory.is_dir():
            return []
        steps = []
        for p in self.directory.iterdir():
            m = _STEP_DIR.match(p.name)
            if m and p.is_dir():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _dcp_kwargs(self) -> dict:
        if self._group is None:
            return {"no_dist": True}
        return {"process_group": self._group}

    def _finalize(self, step: int, mesh_spec) -> None:
        """Rank 0: rename the step's tmp directory, write its manifest and
        rotate; then every rank meets at a barrier."""
        if self._rank == 0:
            tmp, final = self._tmp_dir(step), self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            try:
                write_manifest(final, step=step, mesh=mesh_spec)
            except OSError as e:
                # an unmanifested step still restores through the
                # unverified path
                logger.warning("could not write manifest for step %d: %s",
                               step, e)
            if self.num_to_keep is not None:
                for old in self.all_steps()[:-self.num_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._barrier()

    def _finish_pending(self) -> None:
        """Wait for the save in flight (if any) and finalize it."""
        if self._pending is None:
            return
        step, future, mesh_spec = self._pending
        self._pending = None
        t0 = time.perf_counter()
        future.result()
        self._finalize(step, mesh_spec)
        self.wait_seconds += time.perf_counter() - t0

    # -- save ----------------------------------------------------------

    def should_checkpoint(self, step: int, *, last: bool = False) -> bool:
        if last:
            return True
        return (self.save_every_steps is not None and step > 0
                and step % self.save_every_steps == 0)

    def save(self, step: int, arrays: dict[str, Any], meta: dict[str, Any],
             *, mesh_spec: dict[str, Any] | None = None) -> None:
        """Save one step. ``arrays`` is a nested dict of tensors (plain or
        ``DTensor``); ``meta`` is JSON; ``mesh_spec``
        (``resilience/manifest.py`` ``job_mesh_spec``) goes into the step's
        manifest."""
        logger.info("checkpointing step %d -> %s", step, self.directory)
        # any earlier save lands (and is finalized) before this one starts:
        # one write in flight at a time
        self._finish_pending()
        t0 = time.perf_counter()
        tmp = self._tmp_dir(step)
        if self._rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            with open(tmp / META_NAME, "w") as fh:
                json.dump(meta, fh)
        # DCP's writer makes the directory on every rank: none may start
        # before rank 0 has cleared and made it
        self._barrier()
        kwargs = dict(checkpoint_id=str(tmp), **self._dcp_kwargs())
        if self.async_save:
            staged = _map_tensors(_stage, arrays)
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="d9d-checkpoint")
            future = self._pool.submit(dcp.save, staged, **kwargs)
            self._pending = (step, future, mesh_spec)
        else:
            dcp.save(arrays, **kwargs)
            self._finalize(step, mesh_spec)
        self.last_saved_step = step
        self.saves += 1
        self.save_seconds += time.perf_counter() - t0

    def wait_until_finished(self) -> None:
        """Block until the save in flight is on disk and finalized."""
        self._finish_pending()

    # -- load ----------------------------------------------------------

    def _restore_one(self, step: int, arrays: dict[str, Any],
                     target_mesh) -> tuple[int, dict[str, Any],
                                           dict[str, Any]]:
        step_dir = self._step_dir(step)
        t0 = time.perf_counter()
        if not validate_checkpoint_dir(step_dir):
            self.unverified_restore += 1
            _note_unverified_restore(step)
        self.validate_seconds += time.perf_counter() - t0
        saved_mesh = manifest_mesh(step_dir)
        if topology_mismatch(saved_mesh, target_mesh):
            self.reshard_restores += 1
            logger.warning(
                "checkpoint step %d was saved on another mesh (%s -> %s); "
                "resharding on load", step,
                {k: saved_mesh.get(k) for k in ("device_count", "axes")},
                {k: target_mesh.get(k) for k in ("device_count", "axes")})
        with open(step_dir / META_NAME) as fh:
            meta = json.load(fh)
        dcp.load(arrays, checkpoint_id=str(step_dir), **self._dcp_kwargs())
        self.restore_seconds += time.perf_counter() - t0
        return step, arrays, meta

    def restore(self, arrays: dict[str, Any], step: int | None = None, *,
                mesh_spec: dict[str, Any] | None = None,
                ) -> tuple[int, dict[str, Any], dict[str, Any]] | None:
        """Load a step into ``arrays`` in place (the live state: plain
        tensors and ``DTensor`` pieces, on any mesh) and return ``(step,
        arrays, meta)``. ``mesh_spec`` is the restore target's mesh block,
        held against the step's manifest. ``step=None`` walks back from
        the newest step (see the module docstring); an explicit ``step``
        raises on any failure."""
        self._finish_pending()
        if step is not None:
            result = self._restore_one(step, arrays, mesh_spec)
            self.last_saved_step = None  # the save timeline restarts here
            return result
        candidates = sorted(self.all_steps(), reverse=True)
        confirmed_corrupt: list[int] = []
        last_error: Exception | None = None
        for s in candidates:
            try:
                result = self._restore_one(s, arrays, mesh_spec)
            # DCP's CheckpointException is a BaseException
            except (Exception, CheckpointException) as e:  # noqa: BLE001
                self.checkpoint_fallback += 1
                logger.error(
                    "checkpoint step %d is not restorable (%s: %s); falling "
                    "back to the previous rotation entry",
                    s, type(e).__name__, e)
                # only a manifest-confirmed corruption may be pruned; a
                # transient failure must never cost an intact checkpoint
                if isinstance(e, CheckpointIntegrityError):
                    confirmed_corrupt.append(s)
                last_error = e
                continue
            # restored by walking back: drop the CONFIRMED-corrupt newer
            # steps so training replayed past them can save them again and
            # they never shadow this step as the latest; rank 0 alone
            # deletes on the shared directory
            if self._rank == 0:
                for dead in confirmed_corrupt:
                    shutil.rmtree(self._step_dir(dead), ignore_errors=True)
            self._barrier()
            self.last_saved_step = None
            return result
        if candidates:
            # checkpoints exist but none restored: silently training from
            # scratch (and eventually rotating the old run's data away)
            # would be quiet data loss — fail for the operator
            raise RuntimeError(
                f"none of the checkpoint steps {candidates} could be "
                "restored; refusing to silently start from scratch"
            ) from last_error
        return None

    def close(self) -> None:
        """Flush the save in flight and its manifest; stop the writer
        thread."""
        self._finish_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
