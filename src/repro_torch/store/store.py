"""Row-granular chunked on-disk client store.

``ClientStore`` keeps one row per client for every registered field
(params / momentum / EF residual / push-sum weight / last loss) in
``rows_per_chunk``-row chunk files, each written atomically with fsync.
Reads and writes take arbitrary global row-id sets and touch only the
chunks those ids fall into; chunks that were never written are synthesized
from the field defaults / init templates, so store creation is O(1) in n.

Durability is generational copy-on-write (format 2, see
:mod:`repro_torch.store.layout`): every chunk rewrite lands in a fresh
``rows_<start>.g<gen>.npz`` file whose checksum and dirty-row set are
recorded in the manifest at the next :meth:`ClientStore.update_meta`
commit.  Fault-in verifies the checksum: a mismatching chunk is moved to
``quarantine/`` and either rebuilt from the templates (when none of its
rows ever held trained data) or surfaced as a loud
:class:`~repro_torch.store.faults.StoreCorruptionError` naming the chunk, the
file, the committed round, and the rows at stake — flipped bits are never
silently consumed.  Transient read/write ``OSError`` is retried with
bounded exponential backoff (:func:`~repro_torch.store.faults.retry_transient`),
and every injected-fault hook of an attached
:class:`~repro_torch.store.faults.FaultInjector` wraps the real file ops.

This is a host-side subsystem — numpy only, no jax — the paging layer
(:mod:`repro_torch.store.paging`) owns device placement.
"""
from __future__ import annotations

import io
import json
import os
import threading

import numpy as np

from repro_torch.store.faults import StoreCorruptionError, retry_transient
from repro_torch.store.layout import (
    CHECKSUM_ALGO,
    MANIFEST_NAME,
    QUARANTINE_DIR,
    STORE_FORMAT,
    FieldSpec,
    blob_filename,
    checksum,
    gen_filename,
    parse_chunk_filename,
    template_filename,
    write_bytes_atomic,
    write_json_atomic,
    npy_bytes,
    npz_bytes,
)

__all__ = ["ClientStore"]


def _seal_manifest(manifest: dict) -> dict:
    """Embed a self-checksum over the manifest's canonical JSON form.

    The manifest is the recovery root: every chunk and blob checksum
    lives inside it, so a flipped bit in the manifest itself would
    otherwise be the one corruption the store could not detect.  The
    seal is computed over ``json.dumps(..., sort_keys=True)`` of the
    manifest minus the seal field, which round-trips bit-stable through
    ``json.load``."""
    body = {k: v for k, v in manifest.items() if k != "manifest_crc"}
    manifest["manifest_crc"] = checksum(
        json.dumps(body, sort_keys=True).encode()
    )
    return manifest


def _check_manifest_seal(manifest: dict, mpath: str):
    crc = manifest.get("manifest_crc")
    if crc is None:
        return  # pre-seal manifest (format 1, or an older format 2)
    body = {k: v for k, v in manifest.items() if k != "manifest_crc"}
    if checksum(json.dumps(body, sort_keys=True).encode()) != int(crc):
        raise StoreCorruptionError(
            f"store manifest {mpath} fails its self-checksum — the commit "
            "record itself is corrupt and there is no older commit to "
            "roll back to; restore the directory from a replica",
            path=mpath,
        )


class ClientStore:
    """A directory of chunked per-client rows behind a manifest.

    Use :meth:`create` / :meth:`open`; the constructor takes a parsed
    manifest.  All row ids are global ``[0, n)`` ints; ``read_rows`` /
    ``write_rows`` move ``{field: (k, *field.shape)}`` stacks.

    ``faults`` (optional :class:`~repro_torch.store.faults.FaultInjector`) sits
    behind every real file operation; the self-healing counters
    ``io_retries`` / ``backoff_seconds`` / ``corrupt_chunks`` /
    ``rebuilt_rows`` account what the store absorbed.
    """

    def __init__(self, path: str, manifest: dict, faults=None):
        self.path = os.path.abspath(path)
        if manifest.get("format", 0) > STORE_FORMAT:
            raise ValueError(
                f"store {path} has format {manifest['format']} > supported "
                f"{STORE_FORMAT}; upgrade the reader"
            )
        algo = manifest.get("checksum_algo")
        if algo is not None and algo != CHECKSUM_ALGO:
            raise ValueError(
                f"store {path} records checksums under {algo!r} but this "
                f"build verifies {CHECKSUM_ALGO!r}; refusing to mis-verify "
                "(re-create the store or install a matching crc32c wheel)"
            )
        self.n = int(manifest["n"])
        self.rows_per_chunk = int(manifest["rows_per_chunk"])
        self.fields = {
            name: FieldSpec.from_json(name, d)
            for name, d in manifest["fields"].items()
        }
        self._meta = dict(manifest.get("meta", {}))
        self._templates: dict[str, np.ndarray | None] = {}
        # Current generation map: chunk start -> {"file", "crc", "dirty"}.
        # ``crc`` None means an adopted legacy (format-1) chunk whose bytes
        # were written before checksums existed — verification is skipped
        # until the first rewrite records one.  ``dirty`` is the set of
        # global row ids that ever held real (non-template) data.
        self._chunks: dict[int, dict] = {}
        for key, ent in (manifest.get("chunks") or {}).items():
            start = int(key)
            dirty = ent.get("dirty", [])
            if dirty == "all":
                end = min(start + self.rows_per_chunk, self.n)
                dirty = range(start, end)
            self._chunks[start] = {
                "file": ent["file"],
                "crc": None if ent.get("crc") is None else int(ent["crc"]),
                "dirty": set(int(r) for r in dirty),
            }
        self._blobs: dict[str, dict] = {
            name: {"file": ent["file"], "crc": int(ent["crc"])}
            for name, ent in (manifest.get("blobs") or {}).items()
        }
        gens = [0]
        for ent in self._chunks.values():
            parsed = parse_chunk_filename(ent["file"])
            if parsed is not None:
                gens.append(parsed[1])
        for ent in self._blobs.values():
            tail = ent["file"].rsplit(".g", 1)[-1]
            if tail.endswith(".npy"):
                try:
                    gens.append(int(tail[: -len(".npy")]))
                except ValueError:
                    pass
        self._gen = max(gens)
        # Files superseded since the last manifest commit; GC'd only AFTER
        # the next commit publishes their replacements, so the committed
        # state stays intact on disk at every instant.
        self._replaced: set[str] = set()
        self._lock = threading.Lock()
        self.faults = faults
        self._retry_rng = np.random.default_rng(0xFA017)
        # Bytes actually written to chunk files (lazy chunks excluded) —
        # the allocation-accounting tests read this.
        self.bytes_written = 0
        self.chunks_written = 0
        # Self-healing accounting.
        self.io_retries = 0
        self.backoff_seconds = 0.0
        self.corrupt_chunks = 0
        self.rebuilt_rows = 0

    # -- construction ---------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        n: int,
        fields: dict[str, FieldSpec],
        rows_per_chunk: int = 256,
        templates: dict[str, np.ndarray] | None = None,
        meta: dict | None = None,
        faults=None,
    ) -> "ClientStore":
        """Initialize a fresh store directory (refuses to clobber one)."""
        if n <= 0:
            raise ValueError("n must be positive")
        if rows_per_chunk <= 0:
            raise ValueError("rows_per_chunk must be positive")
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(mpath):
            raise FileExistsError(
                f"{path} already holds a client store; open() it instead"
            )
        manifest = {
            "format": STORE_FORMAT,
            "checksum_algo": CHECKSUM_ALGO,
            "n": int(n),
            "rows_per_chunk": int(rows_per_chunk),
            "fields": {name: f.to_json() for name, f in fields.items()},
            "chunks": {},
            "blobs": {},
            "meta": dict(meta or {}),
        }
        for name, row in (templates or {}).items():
            spec = fields[name]
            row = np.asarray(row, dtype=spec.dtype)
            if row.shape != spec.shape:
                raise ValueError(
                    f"template for {name!r} has shape {row.shape}, "
                    f"field expects {spec.shape}"
                )
            with open(os.path.join(path, template_filename(name)), "wb") as f:
                np.save(f, row)
                f.flush()
                os.fsync(f.fileno())
        write_json_atomic(mpath, _seal_manifest(manifest))
        return cls(path, manifest, faults=faults)

    @classmethod
    def open(cls, path: str, faults=None) -> "ClientStore":
        """Open an existing store, rolling the directory back to its last
        committed state: stale ``*.tmp`` droppings and chunk/blob
        generations the manifest does not reference (writes that landed
        after the last commit, or died mid-flight) are deleted, so a
        reopen after any crash is bit-identical to the last commit.
        Format-1 stores are adopted in place (legacy chunks become
        generation 0, unverified until rewritten)."""
        mpath = os.path.join(path, MANIFEST_NAME)
        with open(mpath) as f:
            try:
                manifest = json.load(f)
            except ValueError as e:
                raise StoreCorruptionError(
                    f"store manifest {mpath} is not parseable JSON — the "
                    "commit record itself is corrupt; restore the "
                    f"directory from a replica ({e})",
                    path=mpath,
                ) from e
        _check_manifest_seal(manifest, mpath)
        if "chunks" not in manifest:
            # Format-1 adoption: every legacy chunk file on disk was
            # written with real data, so its whole row range is dirty —
            # corruption of adopted chunks must raise, never rebuild.
            chunks = {}
            for name in os.listdir(path):
                parsed = parse_chunk_filename(name)
                if parsed is not None and parsed[1] == 0:
                    chunks[str(parsed[0])] = {
                        "file": name, "crc": None, "dirty": "all",
                    }
            manifest["chunks"] = chunks
        referenced = {ent["file"] for ent in manifest["chunks"].values()}
        referenced |= {
            ent["file"] for ent in (manifest.get("blobs") or {}).values()
        }
        for name in os.listdir(path):
            full = os.path.join(path, name)
            if not os.path.isfile(full):
                continue
            stale = name.endswith(".tmp")
            if not stale and name not in referenced:
                stale = (parse_chunk_filename(name) is not None
                         or name.startswith("blob_"))
            if stale:
                os.remove(full)
        return cls(path, manifest, faults=faults)

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(os.path.join(path, MANIFEST_NAME))

    # -- metadata -------------------------------------------------------------

    @property
    def meta(self) -> dict:
        return dict(self._meta)

    def update_meta(self, **kv):
        """Merge scalar metadata (round counter, PRNG key words, config
        fingerprints) into the manifest, atomically and durably — this is
        the store's checkpoint commit point.  The manifest publishes the
        current chunk/blob generation map (file + checksum + dirty rows);
        only after it is durable are the superseded generations GC'd."""
        self._meta.update(kv)
        with self._lock:
            chunks = {}
            for start, ent in self._chunks.items():
                end = min(start + self.rows_per_chunk, self.n)
                dirty = (
                    "all" if len(ent["dirty"]) == end - start
                    else sorted(ent["dirty"])
                )
                chunks[str(start)] = {
                    "file": ent["file"], "crc": ent["crc"], "dirty": dirty,
                }
            blobs = {
                name: {"file": ent["file"], "crc": ent["crc"]}
                for name, ent in self._blobs.items()
            }
            replaced, self._replaced = self._replaced, set()
        manifest = {
            "format": STORE_FORMAT,
            "checksum_algo": CHECKSUM_ALGO,
            "n": self.n,
            "rows_per_chunk": self.rows_per_chunk,
            "fields": {k: f.to_json() for k, f in self.fields.items()},
            "chunks": chunks,
            "blobs": blobs,
            "meta": self._meta,
        }
        try:
            self._retrying_write(
                os.path.join(self.path, MANIFEST_NAME),
                lambda p: write_json_atomic(
                    p, _seal_manifest(manifest), faults=self.faults
                ),
            )
        except BaseException:
            # Commit did not land: keep the superseded files — the old
            # manifest still references them.
            with self._lock:
                self._replaced |= replaced
            raise
        for name in replaced:
            try:
                os.remove(os.path.join(self.path, name))
            except FileNotFoundError:
                pass

    def template(self, field: str) -> np.ndarray | None:
        if field not in self._templates:
            p = os.path.join(self.path, template_filename(field))
            self._templates[field] = np.load(p) if os.path.exists(p) else None
        return self._templates[field]

    @property
    def row_nbytes(self) -> int:
        return sum(f.row_nbytes for f in self.fields.values())

    # -- fault-aware file IO ---------------------------------------------------

    def _count_retry(self, delay: float):
        with self._lock:
            self.io_retries += 1
            self.backoff_seconds += float(delay)

    def _read_file(self, path: str) -> bytes:
        """Read a file's bytes, retrying transient (injected or real)
        ``OSError`` with bounded backoff."""

        def attempt():
            if self.faults is not None:
                self.faults.on_read(path)
            with open(path, "rb") as f:
                return f.read()

        return retry_transient(
            attempt, rng=self._retry_rng, on_retry=self._count_retry
        )

    def _retrying_write(self, path: str, write):
        return retry_transient(
            lambda: write(path), rng=self._retry_rng,
            on_retry=self._count_retry,
        )

    def _quarantine(self, filename: str) -> str:
        qdir = os.path.join(self.path, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, filename)
        os.replace(os.path.join(self.path, filename), dst)
        return dst

    # -- chunk materialization -------------------------------------------------

    def _default_chunk(self, start: int) -> dict:
        rows = min(self.rows_per_chunk, self.n - start)
        out = {}
        for name, spec in self.fields.items():
            tpl = self.template(name)
            if tpl is not None:
                out[name] = np.broadcast_to(
                    tpl, (rows,) + spec.shape
                ).copy()
            else:
                out[name] = np.full(
                    (rows,) + spec.shape, spec.default, dtype=spec.dtype
                )
        return out

    def _load_chunk(self, start: int) -> dict:
        with self._lock:
            ent = self._chunks.get(start)
            ent = None if ent is None else dict(ent)
        if ent is None:
            return self._default_chunk(start)
        path = os.path.join(self.path, ent["file"])
        data = self._read_file(path)
        if ent["crc"] is not None and checksum(data) != ent["crc"]:
            qpath = self._quarantine(ent["file"])
            with self._lock:
                self.corrupt_chunks += 1
                dirty = sorted(ent["dirty"])
                if not dirty:
                    # No row of this chunk ever held trained data: the
                    # bytes are reproducible from the templates.  Drop the
                    # generation and rebuild.
                    self._chunks.pop(start, None)
                    rows = min(self.rows_per_chunk, self.n - start)
                    self.rebuilt_rows += rows
            if dirty:
                raise StoreCorruptionError(
                    f"chunk rows[{start}:{start + self.rows_per_chunk}) of "
                    f"store {self.path} failed checksum verification "
                    f"(file {ent['file']}, committed round "
                    f"{self._meta.get('round')}); {len(dirty)} dirty rows "
                    f"at stake, quarantined to {qpath}",
                    chunk_start=start, path=qpath,
                    round_no=self._meta.get("round"), dirty_rows=dirty,
                )
            return self._default_chunk(start)
        with np.load(io.BytesIO(data)) as loaded:
            return {name: loaded[name] for name in self.fields}

    def _write_chunk(self, start: int, chunk: dict, dirty_ids):
        data = npz_bytes(chunk)
        crc = checksum(data)
        with self._lock:
            self._gen += 1
            fname = gen_filename(start, self._gen)
        self._retrying_write(
            os.path.join(self.path, fname),
            lambda p: write_bytes_atomic(p, data, faults=self.faults),
        )
        with self._lock:
            old = self._chunks.get(start)
            dirty = set(old["dirty"]) if old is not None else set()
            dirty.update(int(i) for i in dirty_ids)
            if old is not None:
                self._replaced.add(old["file"])
            self._chunks[start] = {"file": fname, "crc": crc, "dirty": dirty}
            self.chunks_written += 1
            self.bytes_written += sum(a.nbytes for a in chunk.values())

    def _chunk_groups(self, ids: np.ndarray):
        """Group sorted positions of ``ids`` by owning chunk."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise IndexError(f"row ids out of range [0, {self.n})")
        starts = (ids // self.rows_per_chunk) * self.rows_per_chunk
        order = np.argsort(starts, kind="stable")
        groups = []
        i = 0
        while i < len(order):
            j = i
            s = starts[order[i]]
            while j < len(order) and starts[order[j]] == s:
                j += 1
            groups.append((int(s), order[i:j]))
            i = j
        return ids, groups

    # -- row I/O ---------------------------------------------------------------

    def read_rows(self, ids, fields=None) -> dict:
        """Gather rows ``ids`` (any order, duplicates allowed) into
        ``{field: (len(ids), *shape)}`` stacks, in the order given."""
        names = list(fields) if fields is not None else list(self.fields)
        ids, groups = self._chunk_groups(ids)
        out = {
            name: np.empty(
                (len(ids),) + self.fields[name].shape,
                dtype=self.fields[name].dtype,
            )
            for name in names
        }
        for start, pos in groups:
            chunk = self._load_chunk(start)
            local = ids[pos] - start
            for name in names:
                out[name][pos] = chunk[name][local]
        return out

    def write_rows(self, ids, values: dict):
        """Scatter row stacks back, read-modify-writing each touched chunk
        into a fresh generation.  ``values`` may cover any subset of the
        fields; ids must be unique.  Written ids join the chunk's dirty
        set (recorded at the next commit)."""
        ids, groups = self._chunk_groups(ids)
        if len(np.unique(ids)) != len(ids):
            raise ValueError("write_rows ids must be unique")
        unknown = set(values) - set(self.fields)
        if unknown:
            raise KeyError(f"unknown store fields: {sorted(unknown)}")
        for start, pos in groups:
            chunk = self._load_chunk(start)
            local = ids[pos] - start
            for name, stacked in values.items():
                chunk[name][local] = np.asarray(
                    stacked, dtype=self.fields[name].dtype
                )[pos]
            self._write_chunk(start, chunk, ids[pos])

    def iter_chunks(self, fields=None):
        """Stream ``(start, {field: slab})`` over the whole population in
        row order — lazy chunks synthesized — without ever holding more
        than one chunk in memory.  The paged trainer's full-bank reductions
        (consensus mean, total push-sum mass) are built on this."""
        names = list(fields) if fields is not None else list(self.fields)
        for start in range(0, self.n, self.rows_per_chunk):
            chunk = self._load_chunk(start)
            yield start, {name: chunk[name] for name in names}

    def field_sum(self, field: str, dtype=np.float64):
        """Exact streaming sum of one scalar/vector field over all n rows."""
        spec = self.fields[field]
        total = np.zeros(spec.shape, dtype=dtype)
        for _, chunk in self.iter_chunks(fields=[field]):
            total += chunk[field].astype(dtype).sum(axis=0)
        return total

    # -- sidecar blobs ---------------------------------------------------------

    def write_blob(self, name: str, arr):
        """Write a small named sidecar array (e.g. the churn liveness
        vector) with the same generational + checksummed discipline as
        chunks; committed by the next :meth:`update_meta`."""
        data = npy_bytes(np.asarray(arr))
        crc = checksum(data)
        with self._lock:
            self._gen += 1
            fname = blob_filename(name, self._gen)
        self._retrying_write(
            os.path.join(self.path, fname),
            lambda p: write_bytes_atomic(p, data, faults=self.faults),
        )
        with self._lock:
            old = self._blobs.get(name)
            if old is not None:
                self._replaced.add(old["file"])
            self._blobs[name] = {"file": fname, "crc": crc}

    def read_blob(self, name: str):
        """Read a committed sidecar blob; ``None`` if it was never
        written.  Blobs always hold real state, so a checksum mismatch is
        unconditionally a :class:`StoreCorruptionError`."""
        with self._lock:
            ent = self._blobs.get(name)
            ent = None if ent is None else dict(ent)
        if ent is None:
            return None
        data = self._read_file(os.path.join(self.path, ent["file"]))
        if checksum(data) != ent["crc"]:
            qpath = self._quarantine(ent["file"])
            with self._lock:
                self.corrupt_chunks += 1
            raise StoreCorruptionError(
                f"blob {name!r} of store {self.path} failed checksum "
                f"verification (file {ent['file']}, committed round "
                f"{self._meta.get('round')}); quarantined to {qpath}",
                path=qpath, round_no=self._meta.get("round"),
            )
        return np.load(io.BytesIO(data))

    # -- integrity -------------------------------------------------------------

    def verify_chunks(self) -> dict:
        """Re-read and checksum every materialized chunk and blob, plus
        the committed manifest's self-seal.

        Returns ``{"verified": k, "skipped": j, "bytes": b}`` (skipped =
        adopted legacy chunks with no recorded checksum).  Raises
        :class:`StoreCorruptionError` on the first mismatch — verification
        is read-only and does not quarantine."""
        with self._lock:
            chunk_ents = {s: dict(e) for s, e in self._chunks.items()}
            blob_ents = {n: dict(e) for n, e in self._blobs.items()}
        verified = skipped = nbytes = 0
        for start, ent in sorted(chunk_ents.items()):
            if ent["crc"] is None:
                skipped += 1
                continue
            data = self._read_file(os.path.join(self.path, ent["file"]))
            nbytes += len(data)
            if checksum(data) != ent["crc"]:
                raise StoreCorruptionError(
                    f"verify_chunks: chunk rows[{start}:"
                    f"{start + self.rows_per_chunk}) of store {self.path} "
                    f"failed checksum (file {ent['file']})",
                    chunk_start=start,
                    path=os.path.join(self.path, ent["file"]),
                    round_no=self._meta.get("round"),
                    dirty_rows=sorted(ent["dirty"]),
                )
            verified += 1
        for name, ent in sorted(blob_ents.items()):
            data = self._read_file(os.path.join(self.path, ent["file"]))
            nbytes += len(data)
            if checksum(data) != ent["crc"]:
                raise StoreCorruptionError(
                    f"verify_chunks: blob {name!r} of store {self.path} "
                    f"failed checksum (file {ent['file']})",
                    path=os.path.join(self.path, ent["file"]),
                    round_no=self._meta.get("round"),
                )
            verified += 1
        mpath = os.path.join(self.path, MANIFEST_NAME)
        if os.path.exists(mpath):
            data = self._read_file(mpath)
            nbytes += len(data)
            try:
                on_disk = json.loads(data)
            except ValueError as e:
                raise StoreCorruptionError(
                    f"verify_chunks: committed manifest {mpath} is not "
                    f"parseable JSON ({e})",
                    path=mpath, round_no=self._meta.get("round"),
                ) from e
            _check_manifest_seal(on_disk, mpath)
            verified += 1
        return {"verified": verified, "skipped": skipped, "bytes": nbytes}
