"""Crash-safe checkpoint files shared by the port's BFS engines.

Counterpart of ``raft_tpu/resilience/ckpt.py``, with the same file format,
so a checkpoint written by either package loads in the other:

  * ``save_npz`` writes a tmp file, flushes and fsyncs it, rotates the
    previous files through ``path.gen1 .. path.gen{keep-1}`` and
    publishes with ``os.replace`` (then a best-effort directory fsync);
  * every payload carries ``format_version`` (2) and ``content_hash``, a
    blake2b digest over each field's name, dtype, shape and bytes in
    sorted-name order (the payload, not the zip container);
  * ``load_npz`` verifies the hash and falls back to the newest intact
    generation, reporting what it skipped;
  * ``check_spec`` refuses another spec's checkpoint; for the sharded
    engine, whose ident records its mesh size as ``/D=<n>`` (provenance,
    not identity: the payload reshards by fp mod D), a pure mesh-size
    difference is accepted with ``allow_reshard`` and otherwise refused
    with a message that names both mesh sizes.

Version-1 files (no hash) load unverified, as in the reference.
"""

from __future__ import annotations

import hashlib
import os
import re

import numpy as np

from .errors import CheckpointCorrupt, CheckpointMismatch

FORMAT_VERSION = 2
HASH_KEY = "content_hash"
DEFAULT_KEEP = 3


def generation_path(path: str, gen: int) -> str:
    """On-disk name of generation ``gen`` (0 = the live file)."""
    return path if gen == 0 else f"{path}.gen{gen}"


def content_hash(payload: dict) -> str:
    """Digest of a payload: every field's name, dtype, shape and raw
    bytes, in sorted-name order (``content_hash`` is skipped)."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(payload):
        if key == HASH_KEY:
            continue
        arr = np.asarray(payload[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _fsync_dir(dirname: str) -> None:
    """Make the rename durable in the directory entry (best effort)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_npz(path: str, payload: dict, keep: int = DEFAULT_KEEP) -> None:
    """Persist ``payload`` at ``path`` atomically, with its hash, rotating
    up to ``keep`` generations. Each step is crash-safe: the tmp file is
    fsynced before any rename, every rotation rename is atomic, and
    ``os.replace`` publishes the new file."""
    keep = max(1, int(keep))
    payload = dict(payload)
    payload["format_version"] = np.int64(FORMAT_VERSION)
    payload[HASH_KEY] = content_hash(payload)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.npz"  # the .npz suffix stops savez appending one
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)  # uncompressed: large runs must not wait on zlib
        fh.flush()
        os.fsync(fh.fileno())
    for gen in range(keep - 1, 0, -1):  # path -> .gen1 -> .gen2 ...
        newer = generation_path(path, gen - 1)
        if os.path.exists(newer):
            os.replace(newer, generation_path(path, gen))
    os.replace(tmp, path)
    _fsync_dir(parent)


def _read_verify(path: str) -> dict:
    """Load one candidate file and verify it; raises CheckpointCorrupt."""
    try:
        with np.load(path, allow_pickle=False) as ck:
            payload = {k: np.asarray(ck[k]) for k in ck.files}
    except Exception as e:  # zipfile.BadZipFile, OSError, ValueError ...
        raise CheckpointCorrupt(f"{path}: unreadable ({type(e).__name__}: {e})") from e
    # the hash is keyed on the container revision (format_version), not on
    # an engine's own payload-layout "version" field
    version = int(payload["format_version"]) if "format_version" in payload else 1
    if version >= 2:
        stored = str(payload.get(HASH_KEY, ""))
        if not stored:
            raise CheckpointCorrupt(f"{path}: format v{version} but no hash")
        if content_hash(payload) != stored:
            raise CheckpointCorrupt(
                f"{path}: content hash mismatch (truncated or corrupt write)")
    return payload


def load_npz(path: str, keep: int = DEFAULT_KEEP) -> tuple[dict, int, list[str]]:
    """The newest intact generation of ``path``: tries ``path``, then
    ``path.gen1`` .. ``path.gen{keep-1}``. Returns ``(payload,
    generation, skipped)``, ``skipped`` one line per rejected newer
    candidate. Raises FileNotFoundError when no candidate exists and
    CheckpointCorrupt when none is intact."""
    skipped: list[str] = []
    tried_any = False
    for gen in range(max(1, int(keep))):
        cand = generation_path(path, gen)
        if not os.path.exists(cand):
            continue
        tried_any = True
        try:
            return _read_verify(cand), gen, skipped
        except CheckpointCorrupt as e:
            skipped.append(str(e))
    if not tried_any:
        raise FileNotFoundError(f"no checkpoint at {path} (or any .gen* generation)")
    raise CheckpointCorrupt(f"no intact checkpoint generation at {path}",
                            problems=tuple(skipped))


def format_version_of(payload: dict) -> int:
    """The payload's checkpoint-format version (1 for files that carry
    only the engine's own ``version`` field)."""
    if "format_version" in payload:
        return int(payload["format_version"])
    return int(payload.get("version", 1))


_MESH_D_RE = re.compile(r"/D=(\d+)")


def mesh_d_of(spec: str) -> int | None:
    """Mesh size recorded in an ident (``/D=<n>``), or None."""
    m = _MESH_D_RE.search(spec)
    return int(m.group(1)) if m else None


def mesh_neutral(spec: str) -> str:
    """The ident without its ``/D=<n>`` component."""
    return _MESH_D_RE.sub("", spec)


def check_spec(payload: dict, expect_ident: str, path: str,
               allow_reshard: bool = False) -> None:
    """Refuse a checkpoint this build cannot soundly resume: a newer
    format, another spec, or (without ``allow_reshard``) another mesh
    size. The messages are the reference's."""
    version = format_version_of(payload)
    if version > FORMAT_VERSION:
        raise CheckpointMismatch(
            f"{path}: checkpoint format v{version} is newer than this "
            f"build's v{FORMAT_VERSION}; upgrade raft_tpu_torch to resume it")
    spec = str(payload.get("spec", "<missing spec field>"))
    if spec == expect_ident:
        return
    d_ck, d_run = mesh_d_of(spec), mesh_d_of(expect_ident)
    if (d_ck is not None and d_run is not None and d_ck != d_run
            and mesh_neutral(spec) == mesh_neutral(expect_ident)):
        if allow_reshard:
            return
        raise CheckpointMismatch(
            f"{path}: checkpoint was written on a D={d_ck} mesh, this run "
            f"is on D={d_run} — the payload is mesh-portable; drop "
            f"--no-reshard to re-route the shards by fp mod {d_run} on resume")
    raise CheckpointMismatch(f"checkpoint is for spec {spec}, model is {expect_ident}")


def validate_resume(path: str, expect_ident: str, keep: int = DEFAULT_KEEP,
                    allow_reshard: bool = False) -> tuple[int, int]:
    """Fail-fast ``--resume`` check before any device work: the file
    exists, loads (falling back through generations) and matches the
    ident. Returns ``(generation, depth)`` of the checkpoint."""
    payload, gen, _skipped = load_npz(path, keep=keep)
    check_spec(payload, expect_ident, path, allow_reshard=allow_reshard)
    return gen, int(payload.get("depth", 0))


# ---------------- fingerprints on disk ----------------
# Checkpoints store fingerprints as the reference's uint64 values; the
# engines hold the int64 encoding u64 ^ 2^63 (order-preserving).

_SIGN = np.uint64(1 << 63)


def u64_of_enc(a) -> np.ndarray:
    """int64 enc fingerprints -> uint64 values."""
    return np.ascontiguousarray(a, dtype=np.int64).view(np.uint64) ^ _SIGN


def enc_of_u64(a) -> np.ndarray:
    """uint64 fingerprints -> int64 enc values."""
    return (np.ascontiguousarray(a, dtype=np.uint64) ^ _SIGN).view(np.int64)
