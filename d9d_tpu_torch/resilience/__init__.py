"""Checkpoint integrity (counterpart of ``d9d_tpu/resilience``; the
manifest only so far)."""

from d9d_tpu_torch.resilience.manifest import (
    MANIFEST_NAME,
    MANIFEST_VERSION,
    CheckpointIntegrityError,
    ManifestVersionError,
    job_mesh_spec,
    manifest_mesh,
    read_manifest,
    topology_mismatch,
    validate_checkpoint_dir,
    write_manifest,
)

__all__ = [
    "MANIFEST_NAME",
    "MANIFEST_VERSION",
    "CheckpointIntegrityError",
    "ManifestVersionError",
    "job_mesh_spec",
    "manifest_mesh",
    "read_manifest",
    "topology_mismatch",
    "validate_checkpoint_dir",
    "write_manifest",
]
