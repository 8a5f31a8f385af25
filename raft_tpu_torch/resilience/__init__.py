"""Crash-safe checkpoints and the typed failures of the port's engines.

``ckpt`` (hash-verified, generation-rotated ``.npz`` files in the
reference's format, mesh-portable for the sharded engine) and ``errors``.
The reference's supervisor, preemption guard and chaos harness are not
ported yet (ROADMAP.md Queue 1 item 3).
"""

from .ckpt import (
    DEFAULT_KEEP,
    FORMAT_VERSION,
    check_spec,
    content_hash,
    format_version_of,
    generation_path,
    load_npz,
    mesh_d_of,
    mesh_neutral,
    save_npz,
    validate_resume,
)
from .errors import CapacityOverflow, CheckpointCorrupt, CheckpointError, CheckpointMismatch

__all__ = [
    "CapacityOverflow",
    "CheckpointCorrupt",
    "CheckpointError",
    "CheckpointMismatch",
    "DEFAULT_KEEP",
    "FORMAT_VERSION",
    "check_spec",
    "content_hash",
    "format_version_of",
    "generation_path",
    "load_npz",
    "mesh_d_of",
    "mesh_neutral",
    "save_npz",
    "validate_resume",
]
