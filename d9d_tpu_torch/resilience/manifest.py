"""Checkpoint integrity manifests: write-after-finalize, validate-on-restore
(counterpart of ``d9d_tpu/resilience/manifest.py``, a copy, with the mesh
block of ``d9d_tpu/resilience/elastic.py`` ``job_mesh_spec``).

The job checkpointer (``loop/components/checkpointer.py``) finalizes a
step atomically (tmp dir → rename) but says nothing about what is *inside*
the directory: a machine that dies mid-write of one data file, a
filesystem that truncates on quota, or a stray ``rm`` leaves a step that
lists as restorable and explodes (or worse, half-loads) at restore time.
The manifest closes that gap:

- After a save is finalized, :func:`write_manifest` records the full file
  inventory of the step directory — relative path + byte size for every
  file, plus a SHA-256 content checksum for small files (the JSON meta,
  the DCP ``.metadata`` index). The manifest itself is written atomically
  (tmp + rename) *after* everything it describes.
- On restore, :func:`validate_checkpoint_dir` re-walks the directory and
  raises :class:`CheckpointIntegrityError` on any missing file, size
  mismatch, or checksum mismatch. The checkpointer walks back through the
  rotation history to the newest step that validates AND restores,
  instead of crashing on the newest directory.

A step directory without a manifest (a save whose process died between
finalize and manifest write) is treated as *unverified*, not invalid:
restore still attempts it inside the same walk-back guard, so a corrupt
unverified step degrades to a fallback, not a crash.

Schema v2: the manifest also records the **saving mesh** under ``"mesh"``
(:func:`job_mesh_spec`): the ``MeshParameters`` axis sizes (incl.
``dp_replicate`` and ``ep_shard``), the device count, the mesh's axis
sizes by name and the ``zero_sharding`` setting, so a restore can see a
topology mismatch before loading. The JAX block's per-leaf sharding specs
(``leaf_shardings``) are left out: DCP's own ``.metadata`` records where
each piece of each tensor lies, and no reader of the port needs them.
v1 files stay readable; a manifest from a *newer* writer raises
:class:`ManifestVersionError` — which the restore walk-back treats as
"skip this step", never as confirmed corruption (a newer format must not
get an intact checkpoint pruned).
"""

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Any

logger = logging.getLogger("d9d_tpu_torch.resilience")

MANIFEST_NAME = "d9d_manifest.json"
MANIFEST_VERSION = 2

# files at or under this size get full content checksums (the JSON meta
# and DCP's .metadata index qualify); bigger data files are inventoried by
# size — truncation and deletion are caught,
# and the array payloads don't pay a full re-read on every save/restore
_CHECKSUM_MAX_BYTES = 4 * 1024 * 1024


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint step directory failed manifest validation."""


class ManifestVersionError(RuntimeError):
    """The manifest was written by a newer schema than this reader.

    Deliberately NOT a :class:`CheckpointIntegrityError`: the restore
    walk-back prunes integrity-confirmed corrupt steps, and a
    format-from-the-future checkpoint is (presumably) intact — it must
    be skipped, never deleted.
    """


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _inventory(step_dir: Path) -> list[dict[str, Any]]:
    files = []
    for path in sorted(step_dir.rglob("*")):
        if not path.is_file() or path.name == MANIFEST_NAME:
            continue
        size = path.stat().st_size
        entry: dict[str, Any] = {
            "path": path.relative_to(step_dir).as_posix(),
            "size": size,
        }
        if size <= _CHECKSUM_MAX_BYTES:
            entry["sha256"] = _sha256(path)
        files.append(entry)
    return files


def write_manifest(
    step_dir: str | Path, *, step: int, mesh: dict[str, Any] | None = None
) -> Path:
    """Inventory a *finalized* step directory and write its manifest
    atomically. ``mesh`` is the saving-topology block (v2 — see
    :func:`job_mesh_spec`). Returns the manifest path."""
    step_dir = Path(step_dir)
    manifest = {
        "version": MANIFEST_VERSION,
        "step": step,
        "files": _inventory(step_dir),
    }
    if mesh is not None:
        manifest["mesh"] = mesh
    path = step_dir / MANIFEST_NAME
    tmp = step_dir / (MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(step_dir: str | Path) -> dict[str, Any] | None:
    """The parsed manifest, or None when the step has none (unverified).

    Accepts any version ≤ :data:`MANIFEST_VERSION` (the telemetry
    schema's rule); raises :class:`ManifestVersionError` on a manifest
    from a newer writer.
    """
    path = Path(step_dir) / MANIFEST_NAME
    if not path.exists():
        return None
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointIntegrityError(
            f"unreadable checkpoint manifest {path}: {e}"
        ) from e
    version = int(manifest.get("version", 1))
    if version > MANIFEST_VERSION:
        raise ManifestVersionError(
            f"checkpoint manifest {path} has schema version {version}; "
            f"this reader supports <= {MANIFEST_VERSION}"
        )
    return manifest


def manifest_mesh(step_dir: str | Path) -> dict[str, Any] | None:
    """The saving-mesh block of a step's manifest, or None (pre-v2
    manifest, no manifest at all, or unreadable/newer manifest — mesh
    detection is best-effort; integrity validation stays strict)."""
    try:
        manifest = read_manifest(step_dir)
    except (CheckpointIntegrityError, ManifestVersionError):
        return None
    if manifest is None:
        return None
    return manifest.get("mesh")


def validate_checkpoint_dir(step_dir: str | Path) -> bool:
    """Validate a step directory against its manifest.

    Returns True when the manifest exists and every inventoried file
    matches (path present, size equal, checksum equal where recorded);
    False when no manifest exists (unverified — caller may still try
    it). Raises :class:`CheckpointIntegrityError` naming every problem
    when validation *fails*.
    """
    step_dir = Path(step_dir)
    if not step_dir.is_dir():
        raise CheckpointIntegrityError(f"checkpoint dir {step_dir} missing")
    manifest = read_manifest(step_dir)
    if manifest is None:
        return False
    problems: list[str] = []
    for entry in manifest["files"]:
        path = step_dir / entry["path"]
        if not path.is_file():
            problems.append(f"missing file {entry['path']}")
            continue
        size = path.stat().st_size
        if size != entry["size"]:
            problems.append(
                f"size mismatch {entry['path']}: "
                f"{size} != recorded {entry['size']}"
            )
            continue
        digest = entry.get("sha256")
        if digest is not None and _sha256(path) != digest:
            problems.append(f"checksum mismatch {entry['path']}")
    if problems:
        raise CheckpointIntegrityError(
            f"checkpoint {step_dir.name} failed integrity validation: "
            + "; ".join(problems)
        )
    return True


def job_mesh_spec(ctx, *, zero_sharding: bool = False) -> dict[str, Any]:
    """The saving-topology block a checkpoint records (manifest v2
    ``mesh``) for the ``MeshContext`` ``ctx``: its ``MeshParameters``, the
    device count (one device a rank), the axis sizes by name and the
    ``zero_sharding`` setting (no ``leaf_shardings``: see the module
    docstring)."""
    from d9d_tpu_torch.core.mesh import MESH_AXIS_NAMES

    return {
        "zero_sharding": bool(zero_sharding),
        "mesh_parameters": ctx.params.as_dict(),
        "device_count": int(ctx.world_size),
        "axes": dict(zip(MESH_AXIS_NAMES, map(int, ctx.params.axis_sizes))),
    }


def topology_mismatch(
    saved: dict[str, Any] | None, target: dict[str, Any] | None
) -> bool:
    """Did the checkpoint's saving mesh differ from the restore target's
    (``d9d_tpu/resilience/elastic.py`` ``topology_mismatch``, and the
    ``MeshParameters``, whose ``ep_shard`` is no axis)? Unknown on either
    side reads as "no mismatch"."""
    if not saved or not target:
        return False
    if "device_count" in saved and (
        int(saved["device_count"]) != int(target["device_count"])
    ):
        return True
    if saved.get("axes") and dict(saved["axes"]) != dict(target["axes"]):
        return True
    if saved.get("mesh_parameters") and (
        dict(saved["mesh_parameters"]) != dict(target["mesh_parameters"])
    ):
        return True
    return False
