"""On-disk layout of the virtual client population store.

A :class:`~repro_torch.store.store.ClientStore` is one directory:

    store/
      manifest.json            # format version, n, rows_per_chunk, fields,
                               # per-chunk {file, checksum, dirty rows},
                               # free-form scalar meta (round, PRNG key, ...)
      template_params.npy      # one-row init template (broadcast init row)
      rows_00000000.g000001.npz  # chunk generation: rows [0, rows_per_chunk)
      rows_00000256.g000003.npz  # chunk: rows [256, 512), ...
      quarantine/              # checksum-failed chunk files, moved aside

Every *field* is one per-client array (``params`` ``(D,)``, ``mom`` ``(D,)``,
``ef`` ``(D,)``, ``w`` scalar, ``losses`` scalar); a chunk file stores the
row-group slab of every field, so faulting one client touches exactly one
file.  Chunks are **lazy**: a chunk file that was never written simply does
not exist, and reads synthesize its rows from the field defaults / the
one-row templates — creating a 1M-client store writes the manifest plus one
template row, not 1M rows.

Durability (format 2) is generational copy-on-write: a chunk rewrite goes
to a FRESH ``rows_<start>.g<gen>.npz`` file (atomic tmp + fsync + rename),
never in place, and the manifest maps each chunk start to its current
generation file, its CRC32C checksum (CRC32 when no crc32c impl is
baked in — the manifest records which), and the row ids ever written with
real data.  ``update_meta`` — the checkpoint commit point — publishes the
map atomically and only then garbage-collects superseded generations, so
at every instant the last *committed* state is intact on disk:
``ClientStore.open`` deletes unreferenced generations and stale ``*.tmp``
files, recovering bit-identically to the last commit after any crash,
torn write, or post-commit corruption.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import tempfile
import zlib

import numpy as np

__all__ = [
    "STORE_FORMAT",
    "MANIFEST_NAME",
    "CHECKSUM_ALGO",
    "checksum",
    "FieldSpec",
    "chunk_start",
    "chunk_filename",
    "gen_filename",
    "parse_chunk_filename",
    "blob_filename",
    "template_filename",
    "npz_bytes",
    "npy_bytes",
    "write_json_atomic",
    "write_npz_atomic",
    "write_bytes_atomic",
    "fsync_dir",
]

# Bumped whenever the directory layout changes incompatibly.  Format 2
# (generational chunks + checksums) still READS format-1 stores: legacy
# un-suffixed chunk files are adopted as generation 0 with no recorded
# checksum, and the first commit rewrites the manifest as format 2.
STORE_FORMAT = 2
MANIFEST_NAME = "manifest.json"
QUARANTINE_DIR = "quarantine"

# CRC32C (Castagnoli) when a native implementation is available; the
# stdlib's zlib.crc32 otherwise.  A pure-Python CRC32C would be orders of
# magnitude too slow on multi-MB chunks, so the fallback trades the
# polynomial, not the speed — the manifest records which algorithm wrote
# each store and the reader refuses a mismatch instead of mis-verifying.
try:  # pragma: no cover - depends on the environment's wheels
    import google_crc32c as _crc32c_mod

    def _checksum(data: bytes) -> int:
        return int(_crc32c_mod.value(data))

    CHECKSUM_ALGO = "crc32c"
except Exception:  # pragma: no cover
    try:
        import crc32c as _crc32c_mod

        def _checksum(data: bytes) -> int:
            return int(_crc32c_mod.crc32c(data))

        CHECKSUM_ALGO = "crc32c"
    except Exception:
        def _checksum(data: bytes) -> int:
            return zlib.crc32(data) & 0xFFFFFFFF

        CHECKSUM_ALGO = "crc32"


def checksum(data: bytes) -> int:
    """Checksum of a file's exact bytes under :data:`CHECKSUM_ALGO`."""
    return _checksum(data)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One per-client array of the store.

    ``shape`` is the per-row trailing shape (``()`` for scalars).
    ``default`` fills rows of chunks that were never written; a field may
    instead carry a one-row template file (``template_<name>.npy``) — the
    broadcast-init params row — which takes precedence over the scalar.
    """

    name: str
    shape: tuple
    dtype: str
    default: float = 0.0

    def to_json(self) -> dict:
        return {
            "shape": list(self.shape),
            "dtype": self.dtype,
            "default": self.default,
        }

    @classmethod
    def from_json(cls, name: str, d: dict) -> "FieldSpec":
        return cls(name, tuple(d["shape"]), str(d["dtype"]),
                   float(d["default"]))

    @property
    def row_nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * np.prod(self.shape,
                                                           dtype=np.int64))


def chunk_start(row: int, rows_per_chunk: int) -> int:
    return (row // rows_per_chunk) * rows_per_chunk


def chunk_filename(start: int) -> str:
    """Legacy (format-1) un-generational chunk name."""
    return f"rows_{start:08d}.npz"


def gen_filename(start: int, gen: int) -> str:
    """Generational chunk name: ``rows_<start>.g<gen>.npz``."""
    return f"rows_{start:08d}.g{gen:06d}.npz"


def parse_chunk_filename(name: str) -> tuple[int, int] | None:
    """``(start, gen)`` of a chunk file name, or None if not one.
    Legacy names parse as generation 0."""
    if not (name.startswith("rows_") and name.endswith(".npz")):
        return None
    body = name[len("rows_"):-len(".npz")]
    if "." in body:
        start_s, gen_s = body.split(".", 1)
        if not gen_s.startswith("g"):
            return None
        try:
            return int(start_s), int(gen_s[1:])
        except ValueError:
            return None
    try:
        return int(body), 0
    except ValueError:
        return None


def blob_filename(name: str, gen: int) -> str:
    """Generational sidecar blob (e.g. the churn liveness vector)."""
    return f"blob_{name}.g{gen:06d}.npy"


def template_filename(field: str) -> str:
    return f"template_{field}.npy"


def npz_bytes(arrays: dict) -> bytes:
    """Serialize an npz archive to bytes (checksummed before hitting
    disk, so the recorded CRC covers exactly the written file)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def fsync_dir(path: str):
    """Make a rename in ``path`` durable (POSIX: fsync the directory fd)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, writer):
    """Write via tmp file + fsync + rename + dir fsync — a crashed writer
    leaves either the old file or the new one, never a torn chunk."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    fsync_dir(directory)


def write_bytes_atomic(path: str, data: bytes, faults=None):
    """Atomic durable write of pre-serialized bytes, with the fault
    injector's hooks around the real file ops: ``on_write`` may tear the
    write (partial foreign tmp, no rename) or raise an injected kill;
    ``post_write`` may flip a bit of the landed file."""
    if faults is not None:
        faults.on_write(path, data)
    _atomic_write(path, lambda f: f.write(data))
    if faults is not None:
        faults.post_write(path)


def write_json_atomic(path: str, obj: dict, faults=None):
    write_bytes_atomic(
        path, json.dumps(obj, indent=1, sort_keys=True).encode(),
        faults=faults,
    )


def write_npz_atomic(path: str, arrays: dict):
    def writer(f):
        np.savez(f, **arrays)

    _atomic_write(path, writer)
