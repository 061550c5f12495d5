"""Durable graph plane: write-ahead mutation log, graph checkpoints, and
shard fault injection.

The sharded store (``graph/sharded.py``) is fast but volatile: nothing in
the ingest path touches disk, so a crash loses the whole graph. This
module adds the three durability primitives the store wires together (see
``docs/ARCHITECTURE.md`` "Durability & recovery" for the correctness
argument):

**Write-ahead mutation log.** Every sealed ``(shard, epoch)`` appends one
record to the shard's segment file: the epoch's already-byte-stable
``(kind, a, b, packed32_version)`` int32 payload rows, exactly as the
seal applied them. Records are length-prefixed with a CRC32 over the
packed seal version + body, so replaying a shard's records through
``decode_payloads`` + ``DynamicGraph.apply`` reproduces the shard
byte-for-byte. A record is written for EVERY seal — empty epochs write a
zero-row record — which is what makes the durable frontier well defined
(an epoch is durable iff its commit record exists in the control log AND
every shard alive at that epoch has an intact record for it).

Failure handling is asymmetric by design: an *incomplete* record at the
end of a segment is a torn write (the process died mid-append) — it is
truncated away with a warning and recovery proceeds at the durable
frontier. A *complete* record whose CRC does not match, or a length
prefix that cannot frame a record, is corruption — :class:`
WalCorruptionError` names the segment and byte offset and recovery
refuses to guess.

**Control log.** One per store (``control.wal``, same framing, JSON
bodies): a ``meta`` record with the store's construction parameters, one
``plan`` record per re-sharding cutover (the ``RoutingPlan`` history
entry plus the migrated row count), and one ``commit`` record per
globally-sealed epoch carrying the user-ingested packed versions of that
epoch — what lets recovery reconstruct ``latest_sealed()`` exactly
(migration rows are not ingested versions).

**Fsync policy.** ``"always"`` fsyncs every append (maximum durability),
``"batch"`` (the default) group-commits: fsync every ``fsync_every``
records and at rotation/close — the knob the < 15% WAL-overhead
benchmark gate assumes — and ``"never"`` leaves flushing to the OS. The
durable frontier takes the *minimum* over commit and shard-record
completeness, so a lost unsynced suffix degrades recovery depth, never
correctness — which is exactly why a generous batch cadence is safe: the
checkpoint ladder (rotation fsyncs on close) bounds replay depth
independently of the sync count.

**Rotation & truncation.** Segments rotate when a graph checkpoint lands
(:class:`GraphCheckpointManager` snapshots the per-shard stamp/edge
arrays plus plan history and access ledger); segments whose epochs the
checkpoint covers are deleted. The control log is never truncated — it
is the authoritative plan/commit history and grows ~100 bytes per epoch.

**Fault injection.** :class:`FaultInjector` is the seal plane's chaos
hook: the store consults it at seal entry, so an injected fault aborts
the epoch *before* any apply — the epoch stays pending and re-sealable
(invariant I6) and the serving layer keeps answering at the last
published snapshot (degraded mode, invariant I11).

Thread-safety: each :class:`ShardWal` is owned by exactly one shard's
seal and is only ever touched by that shard's apply-plane thread (plus
the serial thread between epochs); :class:`GraphWal`'s control-file
state is guarded by its writer lock (``reprolint`` pins the relation).
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import threading
import time
import warnings
import zlib
from typing import Optional

import numpy as np

from repro_torch.core.versioned import Version
from repro_torch.train.checkpoint import CheckpointManager

# record header: (body length, crc32 over packed+body, packed seal version)
_HDR = struct.Struct(">IIQ")
_PACKED = struct.Struct(">Q")
ROW_BYTES = 16                  # one (kind, a, b, version) int32 payload row
MAX_BODY = 1 << 30              # framing sanity bound: 64M rows per record
_EMPTY_ROWS = np.zeros((0, 4), np.int32)


class WalCorruptionError(RuntimeError):
    """Mid-segment WAL corruption: a complete record whose CRC does not
    match, or a frame that cannot be parsed. Names the segment and byte
    offset; unlike a torn tail this is never silently truncated."""

    def __init__(self, segment, offset: int, reason: str):
        self.segment = str(segment)
        self.offset = int(offset)
        self.reason = reason
        super().__init__(f"{self.segment} @ byte {self.offset}: {reason}")


class ShardFaultError(RuntimeError):
    """A fault injected into a shard's seal (see :class:`FaultInjector`).
    Raised at seal entry, before any apply, so the epoch stays cleanly
    pending and re-sealable."""


def encode_record(packed_version: int, body: bytes) -> bytes:
    """Frame one WAL record: length-prefixed, CRC32 over the packed seal
    version + body (so a swapped version field fails the checksum too)."""
    crc = zlib.crc32(body, zlib.crc32(_PACKED.pack(packed_version)))
    return _HDR.pack(len(body), crc, packed_version) + body


def rows_to_body(rows: np.ndarray) -> bytes:
    """Payload rows -> byte-stable record body (little-endian int32,
    C-order — the same bytes on every platform)."""
    return np.ascontiguousarray(rows, dtype="<i4").tobytes()


def body_to_rows(body: bytes, segment, offset: int) -> np.ndarray:
    """Record body -> ``(N, 4)`` int32 payload rows; a body that is not a
    whole number of rows is corruption, not a torn write (framing already
    proved the record complete)."""
    if len(body) % ROW_BYTES:
        raise WalCorruptionError(
            segment, offset,
            f"body of {len(body)} bytes is not a whole number of "
            f"{ROW_BYTES}-byte payload rows")
    return np.frombuffer(body, "<i4").reshape(-1, 4).astype(np.int32,
                                                            copy=False)


def scan_segment(path, *, tail_ok: bool = True
                 ) -> tuple[list[tuple[int, bytes, int]], int]:
    """Parse one segment file into ``[(packed_version, body, offset)]``
    plus the clean byte length (where a torn tail, if any, starts).

    A record cut off by the end of the file is a torn write: warn and
    stop (the caller may truncate at the returned clean length). With
    ``tail_ok=False`` (non-final segments, which rotation closed after a
    complete record) even a torn tail raises. A complete record failing
    its CRC, or an unframeable length prefix, always raises
    :class:`WalCorruptionError`.
    """
    data = pathlib.Path(path).read_bytes()
    records: list[tuple[int, bytes, int]] = []
    off = 0
    size = len(data)
    while off < size:
        if size - off < _HDR.size:
            break                       # torn mid-header
        body_len, crc, packed = _HDR.unpack_from(data, off)
        if body_len > MAX_BODY:
            raise WalCorruptionError(
                path, off, f"length prefix {body_len} exceeds the "
                f"{MAX_BODY}-byte record bound")
        end = off + _HDR.size + body_len
        if end > size:
            break                       # torn mid-body
        body = data[off + _HDR.size:end]
        want = zlib.crc32(body, zlib.crc32(_PACKED.pack(packed)))
        if want != crc:
            raise WalCorruptionError(
                path, off, f"CRC mismatch (stored {crc:#010x}, "
                f"computed {want:#010x})")
        records.append((packed, body, off))
        off = end
    if off < size:
        if not tail_ok:
            raise WalCorruptionError(
                path, off, f"{size - off} trailing bytes in a closed "
                "segment (rotation always ends on a record boundary)")
        warnings.warn(
            f"torn WAL tail in {path}: dropping {size - off} bytes at "
            f"offset {off} (incomplete record from an interrupted append)",
            stacklevel=2)
    return records, off


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


class ShardWal:
    """Append-only per-shard WAL: one record per sealed epoch, segment
    files named by their first epoch (``seg-<epoch>.wal``).

    Owned by exactly one shard — the store keeps these in a shard-indexed
    list so the seal closure (which may run on the parallel apply plane)
    only ever touches its own writer; no lock is needed (reprolint's
    seal-plane rules treat the list like the other shard-owned state).
    """

    def __init__(self, directory, shard_id: int, *, fsync: str = "batch",
                 fsync_every: int = 32):
        if fsync not in ("always", "batch", "never"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shard_id = shard_id
        self.fsync = fsync
        self.fsync_every = int(fsync_every)
        self._f = None
        self._path: Optional[pathlib.Path] = None
        self._since_sync = 0

    def _open(self, start_epoch: int) -> None:
        self._path = self.dir / f"seg-{start_epoch:08d}.wal"
        self._f = open(self._path, "ab")

    def append(self, epoch: int, rows: np.ndarray) -> None:
        """Append the sealed epoch's payload rows (possibly zero rows —
        every seal writes a record so the durable frontier stays well
        defined). Writes the same bytes as :func:`encode_record` +
        :func:`rows_to_body` but CRCs and writes straight from the array
        buffer — this is the ingest hot path the < 15% overhead gate
        measures, and the intermediate ``tobytes``/concat copies were a
        third of its cost."""
        if self._f is None:
            self._open(epoch)
        packed = Version(epoch, 0).pack()
        arr = np.ascontiguousarray(rows, dtype="<i4")
        body = memoryview(arr).cast("B") if arr.size else b""
        crc = zlib.crc32(body, zlib.crc32(_PACKED.pack(packed)))
        self._f.write(_HDR.pack(len(body), crc, packed))
        self._f.write(body)
        if self.fsync == "always":
            _fsync_file(self._f)
        elif self.fsync == "batch":
            self._since_sync += 1
            if self._since_sync >= self.fsync_every:
                _fsync_file(self._f)
                self._since_sync = 0

    def sync(self) -> None:
        if self._f is not None and self.fsync != "never":
            _fsync_file(self._f)
            self._since_sync = 0

    def close(self) -> None:
        if self._f is not None:
            if self.fsync != "never":
                _fsync_file(self._f)
            self._f.close()
            self._f = None

    def rotate(self, start_epoch: int) -> None:
        """Close the current segment (on a record boundary — which is why
        only the newest segment may carry a torn tail) and start a fresh
        one for ``start_epoch``. Keyed to the checkpoint ladder: the
        store rotates when a checkpoint lands."""
        self.close()
        self._open(start_epoch)

    def drop_segments_below(self, start_epoch: int) -> int:
        """Delete closed segments whose first epoch precedes
        ``start_epoch`` — called after a checkpoint covering them landed
        durably. Returns the number of segments dropped."""
        dropped = 0
        for p in sorted(self.dir.glob("seg-*.wal")):
            if p != self._path and _segment_start(p) < start_epoch:
                p.unlink()
                dropped += 1
        return dropped

    def segments(self) -> list[pathlib.Path]:
        return sorted(self.dir.glob("seg-*.wal"), key=_segment_start)


def _segment_start(path: pathlib.Path) -> int:
    return int(path.stem.split("-", 1)[1])


def scan_shard_records(directory) -> dict[int, tuple[np.ndarray,
                                                     pathlib.Path, int]]:
    """Read a shard's whole WAL: ``{epoch: (rows, segment, offset)}``.

    Only the newest segment may end in a torn tail (older ones were
    closed on a record boundary by rotation); corruption raises. Offsets
    let recovery truncate complete-but-uncommitted records away so a
    re-seal after recovery cannot double-append.
    """
    segs = sorted(pathlib.Path(directory).glob("seg-*.wal"),
                  key=_segment_start)
    out: dict[int, tuple[np.ndarray, pathlib.Path, int]] = {}
    for i, seg in enumerate(segs):
        records, _ = scan_segment(seg, tail_ok=(i == len(segs) - 1))
        for packed, body, off in records:
            epoch = Version.unpack(packed).epoch
            out[epoch] = (body_to_rows(body, seg, off), seg, off)
    return out


def truncate_shard_after(directory, last_epoch: int) -> int:
    """Drop every record with epoch > ``last_epoch`` from a shard's WAL
    (they are a suffix: epochs append in order). Returns records dropped.
    Recovery calls this so re-ingested epochs re-append cleanly."""
    dropped = 0
    for seg in sorted(pathlib.Path(directory).glob("seg-*.wal"),
                      key=_segment_start, reverse=True):
        records, clean = scan_segment(seg)
        keep = [off for packed, _, off in records
                if Version.unpack(packed).epoch <= last_epoch]
        if len(keep) == len(records) and clean == seg.stat().st_size:
            break                       # nothing newer remains below
        dropped += len(records) - len(keep)
        if keep:
            cut = records[len(keep)][2] if len(keep) < len(records) \
                else clean
            with open(seg, "r+b") as f:
                f.truncate(cut)
            break
        seg.unlink()
    return dropped


class GraphWal:
    """Store-level WAL manager: the control log plus the per-shard
    segment-writer factory.

    The control log records, in append order: one ``meta`` record (store
    construction parameters), a ``plan`` record per re-sharding cutover,
    and a ``commit`` record per globally-sealed epoch (its user-ingested
    packed versions). Bodies are JSON; framing and failure handling are
    shared with the shard segments. ``_lock`` is the WAL writer lock
    guarding the control-file handle and its fsync batcher (the store's
    serial thread is the only caller today; the lock pins the discipline
    for the multi-host plane the ROADMAP sketches).
    """

    def __init__(self, directory, *, fsync: str = "batch",
                 fsync_every: int = 32):
        if fsync not in ("always", "batch", "never"):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.fsync_every = int(fsync_every)
        self._lock = threading.Lock()
        self._control_f = open(self.control_path(self.dir), "ab")
        self._control_synced = 0

    @staticmethod
    def control_path(directory) -> pathlib.Path:
        return pathlib.Path(directory) / "control.wal"

    @staticmethod
    def shard_dir(directory, shard_id: int) -> pathlib.Path:
        return pathlib.Path(directory) / f"shard-{shard_id:04d}"

    def shard_wal(self, shard_id: int) -> ShardWal:
        return ShardWal(self.shard_dir(self.dir, shard_id), shard_id,
                        fsync=self.fsync, fsync_every=self.fsync_every)

    # -- control appends ---------------------------------------------------
    def _append_control(self, epoch: int, record: dict) -> None:
        payload = json.dumps(record, sort_keys=True).encode()
        framed = encode_record(Version(max(epoch, 0), 0).pack(), payload)
        with self._lock:
            self._control_f.write(framed)
            if self.fsync == "always":
                _fsync_file(self._control_f)
            elif self.fsync == "batch":
                self._control_synced += 1
                if self._control_synced >= self.fsync_every:
                    _fsync_file(self._control_f)
                    self._control_synced = 0

    def write_meta(self, params: dict) -> None:
        self._append_control(0, {"type": "meta", **params})

    def record_plan_event(self, op: str, a: int, b: int,
                          activation: int, migrated: int) -> None:
        """One record per re-sharding cutover — the durable twin of the
        ``RoutingPlan`` history entry ``(op, a, b, activation)`` (for a
        split, ``a``/``b`` are source/new shard; for a merge,
        survivor/removed), plus the migrated row count the store's
        ``migrations`` telemetry keeps."""
        self._append_control(activation, {
            "type": "plan", "op": op, "a": a, "b": b,
            "activation": activation, "migrated": migrated})

    def commit_epoch(self, epoch: int, ingested_packed: list[int]) -> None:
        """Mark ``epoch`` globally sealed, carrying its user-ingested
        packed versions (the entries ``latest_sealed()`` answers from;
        migration rows are deliberately absent)."""
        self._append_control(epoch, {
            "type": "commit", "epoch": epoch,
            "versions": [int(v) for v in ingested_packed]})

    def sync(self) -> None:
        with self._lock:
            if self.fsync != "never":
                _fsync_file(self._control_f)
                self._control_synced = 0

    def close(self) -> None:
        with self._lock:
            if self.fsync != "never":
                _fsync_file(self._control_f)
            self._control_f.close()

    # -- control scan (recovery) -------------------------------------------
    @staticmethod
    def read_control(directory) -> tuple[Optional[dict], list[dict],
                                         dict[int, list[int]]]:
        """Parse the control log: ``(meta, plan_events, commits)``.
        ``commits`` maps epoch -> the user-ingested packed versions of
        that epoch. Torn tail warns; corruption raises."""
        path = GraphWal.control_path(directory)
        meta: Optional[dict] = None
        events: list[dict] = []
        commits: dict[int, list[int]] = {}
        if not path.exists():
            return meta, events, commits
        records, _ = scan_segment(path)
        for _, body, off in records:
            try:
                rec = json.loads(body)
            except ValueError as exc:
                raise WalCorruptionError(
                    path, off, f"undecodable control record: {exc}") \
                    from exc
            kind = rec.get("type")
            if kind == "meta":
                meta = rec
            elif kind == "plan":
                events.append(rec)
            elif kind == "commit":
                commits[rec["epoch"]] = rec["versions"]
            else:
                raise WalCorruptionError(
                    path, off, f"unknown control record type {kind!r}")
        return meta, events, commits

    @staticmethod
    def truncate_control_after(directory, last_epoch: int) -> None:
        """Drop commit records with epoch > ``last_epoch`` and plan
        records with activation > ``last_epoch`` (always a suffix —
        control records append in epoch order)."""
        path = GraphWal.control_path(directory)
        if not path.exists():
            return
        records, clean = scan_segment(path)
        cut = clean
        for _, body, off in records:
            rec = json.loads(body)
            beyond = (rec.get("type") == "commit"
                      and rec["epoch"] > last_epoch) or \
                     (rec.get("type") == "plan"
                      and rec["activation"] > last_epoch)
            if beyond:
                cut = off
                break
        if cut < path.stat().st_size:
            with open(path, "r+b") as f:
                f.truncate(cut)


class FaultInjector:
    """Seal-plane chaos hook: kill, stall, or drop a shard's seal.

    The store consults :meth:`check` at seal ENTRY — before any apply —
    so an injected fault aborts the epoch as a clean no-op: the epoch
    stays pending and re-sealable (invariant I6), the global frontier
    holds, and the serving layer degrades to the last published snapshot
    instead of ever exposing a partial one.

    ``fail`` arms a one-shot fault (optionally for one specific epoch);
    ``drop`` takes a shard down persistently until :meth:`heal`;
    ``stall`` delays the seal without failing it (the slow-shard story).
    Thread-safe: seals consult it from the parallel apply plane.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._fail_once: dict[int, Optional[int]] = {}
        self._down: set[int] = set()
        self._stall: dict[int, float] = {}
        self.faults_fired = 0

    def fail(self, shard_id: int, epoch: Optional[int] = None) -> None:
        """Arm a one-shot seal failure on ``shard_id`` (any epoch, or
        only ``epoch``)."""
        with self._lock:
            self._fail_once[shard_id] = epoch

    def drop(self, shard_id: int) -> None:
        """Take a shard down: every seal fails until :meth:`heal`."""
        with self._lock:
            self._down.add(shard_id)

    def stall(self, shard_id: int, seconds: float) -> None:
        """Delay (without failing) the shard's next seals by ``seconds``
        each until cleared by ``stall(shard, 0)`` or :meth:`heal`."""
        with self._lock:
            if seconds > 0:
                self._stall[shard_id] = float(seconds)
            else:
                self._stall.pop(shard_id, None)

    def heal(self, shard_id: Optional[int] = None) -> None:
        """Clear faults for one shard (or all, when None)."""
        with self._lock:
            if shard_id is None:
                self._fail_once.clear()
                self._down.clear()
                self._stall.clear()
            else:
                self._fail_once.pop(shard_id, None)
                self._down.discard(shard_id)
                self._stall.pop(shard_id, None)

    def check(self, shard_id: int, epoch: int) -> None:
        """Called by the store at seal entry; raises
        :class:`ShardFaultError` for an armed fault. Sleeps (outside the
        injector lock) for an armed stall."""
        fire = False
        with self._lock:
            delay = self._stall.get(shard_id, 0.0)
            if shard_id in self._down:
                fire = True
            elif shard_id in self._fail_once:
                want = self._fail_once[shard_id]
                if want is None or want == epoch:
                    del self._fail_once[shard_id]
                    fire = True
            if fire:
                self.faults_fired += 1
        if delay > 0:
            time.sleep(delay)
        if fire:
            raise ShardFaultError(
                f"injected fault: shard {shard_id} cannot seal epoch "
                f"{epoch}")


class GraphCheckpointManager(CheckpointManager):
    """Durable snapshots of a whole :class:`ShardedDynamicGraph`.

    Extends the train plane's :class:`CheckpointManager` (crash-atomic
    ``.npz`` + manifest, versioned GC) with a graph-shaped state dict:
    per-shard stamp/edge arrays trimmed to ``n_edges``, the vertex
    table, and a JSON ``meta`` leaf (plan history, retired set,
    migrations, access ledger scalars, ingest log) encoded as a uint8
    array so one ``.npz`` holds the whole store. ``load_graph`` bypasses
    ``restore``'s like-structure protocol: recovery has no live store to
    mirror yet.
    """

    def save_graph(self, store, *, epoch: int) -> None:
        meta = {
            "epoch": int(epoch),
            "plan_history": [list(ev) for ev in store.plan.history],
            "retired": sorted(store.retired),
            "migrations": store.migrations,
            "last_version": int(store._last_version),
            "ingested_packed": [int(v) for v in store._ingested_packed],
            "stats": {
                "mutations": store.access_stats.mutations.tolist(),
                "queries": store.access_stats.queries.tolist(),
                "epochs_observed": store.access_stats.epochs_observed,
            },
        }
        state: dict = {
            "meta": np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), np.uint8),
            "vertex_heat": store.access_stats.vertex_heat,
        }
        for i, shard in enumerate(store.shards):
            e = shard.n_edges
            last = shard.versions[-1].pack() if shard.versions else -1
            state[f"shard_{i}"] = {
                "src": shard.src[:e].copy(),
                "dst": shard.dst[:e].copy(),
                "created": shard.created[:e].copy(),
                "deleted": shard.deleted[:e].copy(),
                "v_created": shard.v_created.copy(),
                "v_type": shard.v_type.copy(),
                "last_version": np.asarray(last, np.int64),
            }
        self.save(state, epoch=epoch, step=0)

    def load_graph(self) -> Optional[dict]:
        """Latest graph checkpoint as ``{"epoch", "meta", "shards"}`` (or
        None when no checkpoint exists). ``shards`` is a list of array
        dicts, index == shard id."""
        versions = self.index.versions("ckpt")
        if not versions:
            return None
        fname = self.index.get("ckpt", versions[-1])
        with np.load(self.dir / fname) as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads(bytes(flat.pop("meta").tobytes()).decode())
        heat = flat.pop("vertex_heat")
        shards: list[dict] = []
        i = 0
        while f"shard_{i}/src" in flat:
            shards.append({k: flat[f"shard_{i}/{k}"]
                           for k in ("src", "dst", "created", "deleted",
                                     "v_created", "v_type",
                                     "last_version")})
            i += 1
        return {"epoch": meta["epoch"], "meta": meta,
                "vertex_heat": heat, "shards": shards}
