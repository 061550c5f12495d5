"""Versioned dynamic graph store — the tensor data plane of the paper's data
model.

The graph is a capacity-bounded *multi-version*
edge/vertex store: a mutation never overwrites — an edge add writes a row
stamped ``created=v``; an edge delete stamps ``deleted=v``. A snapshot is a
*mask* (``created <= v < deleted``), which is exactly the paper's Fig 3(b)
multi-version item semantics (every version stays addressable), vectorized.

Ingestion (``apply``) is fully vectorized and indexed:

* vertex adds, edge-row appends, and endpoint auto-creation are batched
  NumPy ops — O(batch) with no per-element Python work on arrays;
* edge deletes resolve through a ``(src, dst) -> latest live row``
  :class:`LiveEdgeIndex` — a NumPy open-addressing hash table (int64 key
  slots, int32 row slots, linear probing, batched probe rounds) backed by
  a per-row ``prev-live`` chain (a LIFO stack per key). Both the insert
  and the pop side are whole-batch array ops with **no per-row Python
  loop**, so a threaded caller (the sharded store's parallel apply plane)
  spends the batch inside NumPy kernels that release the GIL instead of
  serialising on a Python dict.

Version stamps (``created`` / ``deleted`` / ``v_created``) are stored
natively in the int32 data-plane packing (``versioned.PACK_BITS``; int32
max is the 'never' sentinel), checked once for overflow at ``apply`` time
(``pack32_checked``). The 64-bit ``Version.pack()`` survives only at the
API boundary (view-cache keys, the batch log, sharded payload rows).

The NumPy stamp and edge arrays are the host truth. The store keeps
device mirrors of ``created`` and ``deleted`` (int32) beside them, updated
in O(batch) by ``apply`` (the appended slice and the rows it tombstones),
so ``snapshot_mask`` runs the ``liveness_mask`` kernel on the mirrors in
place: no repack and no E-sized host-to-device copy on the hot path.

The per-snapshot CSR ("join view", §2.3.3.2) is built once per queried
version and cached — it is what makes the join-group-by operator a segment
reduction. Views are maintained **delta-first**: when a view for an earlier
version is cached, the CSR for the requested version is patched from the
mutation delta (sorted-merge row insert/remove + incremental degree
updates) in O(m + |delta| log |delta|) instead of the full O(E + m log m)
mask-and-re-sort rebuild; past a churn threshold (delta larger than
``churn_threshold`` · m) it falls back to the full rebuild. Rows are kept
in canonical ``(dst, src)`` order so the delta patch and the full rebuild
produce byte-identical CSRs.

``apply`` also evicts cached views with version >= the incoming batch (a
snapshot cached for a not-yet-applied future version would silently go
stale otherwise).

On a CUDA device the snapshot mask goes through the hand-written
``liveness_mask`` kernel; on the CPU through its plain version
(``use_kernel`` overrides, see :mod:`repro_torch.kernels.ops`). Join views
hold their CSR tensors on the store's device.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.versioned import (PACK32_NEVER, Version, pack32_checked,
                                        pack32_clamped)
from repro_torch.device import DEFAULT_DEVICE, resolve_device, to_host
from repro_torch.kernels import ops

# 'never created / never deleted' stamp sentinel. Stamps are int32
# data-plane packed natively (versioned.PACK_BITS); int32 max is reserved.
MAXV = PACK32_NEVER

# Delta-patching a cached view wins while the delta is small relative to the
# live edge count; past this fraction a full mask-and-sort rebuild is cheaper.
DEFAULT_CHURN_THRESHOLD = 0.25


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer (vectorized). Shared by :class:`LiveEdgeIndex`
    (slot hashing) and the sharded store's ``RoutingPlan`` (split-bit
    refinement hash): one well-mixed integer hash, two consumers."""
    x = np.asarray(x)
    # int64 input (the common case: edge keys, routing keys) reinterprets
    # bit-for-bit instead of paying a widening copy
    x = x.view(np.uint64) if x.dtype == np.int64 else x.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class LiveEdgeIndex:
    """Vectorized ``(src, dst) key -> newest live row`` map.

    Open-addressing hash table over parallel NumPy arrays — int64 key
    slots (-1 = empty), int32 row slots (-1 = key present but no live row)
    — with linear probing. Lookups and insert-or-update both run in
    *batched probe rounds*: every still-unresolved key advances one slot
    per round, so the Python-level cost is O(max probe length) loop
    iterations of whole-array work, not O(batch) per-row dict operations.
    Within an insert round, several distinct keys may claim the same empty
    slot; a scatter race arbitrates (duplicate-index scatter keeps the
    last write — whichever key remains in the slot won) and the losers
    keep probing past the now-occupied slot, which is ordinary
    linear-probing semantics.

    Emptied keys (every duplicate popped) keep their slot with row -1
    rather than tombstoning — lookups return -1 either way — and are
    dropped wholesale on the next growth rehash, which bounds table
    occupancy by the live key count, not the all-time key count.
    """

    EMPTY = -1

    def __init__(self, capacity: int = 1024):
        cap = 1 << max(3, int(capacity - 1).bit_length())
        self._keys = np.full(cap, self.EMPTY, np.int64)
        self._rows = np.full(cap, -1, np.int32)
        self._used = 0          # occupied slots, live or emptied

    @property
    def capacity(self) -> int:
        return len(self._keys)

    def _first_slots(self, keys: np.ndarray) -> np.ndarray:
        return (splitmix64(keys)
                & np.uint64(len(self._keys) - 1)).astype(np.int64)

    def slots_of(self, keys: np.ndarray) -> np.ndarray:
        """Table slot per key (-1 when absent), batched — one probe pass.

        The delete path uses this to read AND later write the same keys'
        rows (:meth:`rows_at` / :meth:`set_rows`) with a single probing
        pass instead of a lookup pass plus a store pass. Returned slots
        are invalidated by any subsequent insert (growth rehash).
        """
        keys = np.asarray(keys, np.int64)
        out = np.full(len(keys), -1, np.int64)
        if not len(keys) or not self._used:
            return out
        mask = len(self._keys) - 1
        slot = self._first_slots(keys)
        pending = np.arange(len(keys))
        while pending.size:
            s = slot[pending]
            tk = self._keys[s]
            hit = tk == keys[pending]
            out[pending[hit]] = s[hit]
            pending = pending[~(hit | (tk == self.EMPTY))]
            slot[pending] = (slot[pending] + 1) & mask
        return out

    def rows_at(self, slots: np.ndarray) -> np.ndarray:
        """Rows stored at ``slots_of`` results (-1 rides through for
        absent keys)."""
        out = np.full(len(slots), -1, np.int64)
        found = slots >= 0
        out[found] = self._rows[slots[found]]
        return out

    def set_rows(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Overwrite the rows at valid (>= 0) slots in place (-1 row =
        mark emptied). No probing, no inserts — slot-stable."""
        self._rows[slots] = rows

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Newest live row per key (-1 when absent or emptied), batched."""
        return self.rows_at(self.slots_of(keys))

    def push(self, keys: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Insert-or-update UNIQUE ``key -> row`` and return each key's
        *previous* row (-1 when absent or emptied) — a fused
        lookup + store in one probe pass. The add path chains the batch's
        oldest duplicate to the returned previous top while the newest
        duplicate becomes the stored row."""
        keys = np.asarray(keys, np.int64)
        old = np.full(len(keys), -1, np.int64)
        if not len(keys):
            return old
        self._maybe_grow(len(keys))
        rows32 = np.asarray(rows, np.int32)
        mask = len(self._keys) - 1
        slot = self._first_slots(keys)
        pending = np.arange(len(keys))
        while pending.size:
            s = slot[pending]
            tk = self._keys[s]
            hit = tk == keys[pending]
            if hit.any():
                hs, hp = s[hit], pending[hit]
                old[hp] = self._rows[hs]
                self._rows[hs] = rows32[hp]
            resolved = hit
            empty = tk == self.EMPTY
            if empty.any():
                pos = np.flatnonzero(empty)
                se, cand = s[pos], pending[pos]
                self._keys[se] = keys[cand]          # scatter race: the key
                won = self._keys[se] == keys[cand]   # left standing won
                if won.any():
                    self._rows[se[won]] = rows32[cand[won]]
                    self._used += int(won.sum())
                    resolved = resolved.copy()
                    resolved[pos[won]] = True
            pending = pending[~resolved]
            slot[pending] = (slot[pending] + 1) & mask
        return old

    def store(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Insert-or-update ``key -> row`` for UNIQUE keys, batched.

        ``row`` -1 marks an existing key's stack as emptied (the pop side
        never needs to insert: it only updates keys it just looked up).
        """
        keys = np.asarray(keys, np.int64)
        if not len(keys):
            return
        self._maybe_grow(len(keys))
        rows32 = np.asarray(rows, np.int32)
        mask = len(self._keys) - 1
        slot = self._first_slots(keys)
        pending = np.arange(len(keys))
        while pending.size:
            s = slot[pending]
            tk = self._keys[s]
            hit = tk == keys[pending]
            self._rows[s[hit]] = rows32[pending[hit]]
            resolved = hit
            empty = tk == self.EMPTY
            if empty.any():
                pos = np.flatnonzero(empty)
                se, cand = s[pos], pending[pos]
                self._keys[se] = keys[cand]          # scatter race: the key
                won = self._keys[se] == keys[cand]   # left standing won
                if won.any():
                    self._rows[se[won]] = rows32[cand[won]]
                    self._used += int(won.sum())
                    resolved = resolved.copy()
                    resolved[pos[won]] = True
            pending = pending[~resolved]
            slot[pending] = (slot[pending] + 1) & mask

    def _maybe_grow(self, incoming: int) -> None:
        # keep load factor <= 2/3 so probe chains stay short
        if (self._used + incoming) * 3 <= len(self._keys) * 2:
            return
        live = self._rows != -1            # emptied keys are dropped here
        lk, lr = self._keys[live], self._rows[live]
        need = len(lk) + incoming
        cap = len(self._keys)
        while cap * 2 < need * 3:
            cap <<= 1
        self._keys = np.full(cap, self.EMPTY, np.int64)
        self._rows = np.full(cap, -1, np.int32)
        self._used = 0
        if len(lk):
            self.store(lk, lr)


@dataclasses.dataclass
class MutationBatch:
    """One epoch's worth of mutations (vectorized)."""
    version: Version
    add_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    add_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    del_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    del_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    add_vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    vertex_types: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))

    def __post_init__(self):
        # every consumer (vectorized store, loop oracle, sharded encoder)
        # pairs add_vertices with vertex_types elementwise; a silent
        # truncation to the shorter of the two would drop vertex adds on
        # one path but not another, so the mismatch is resolved here once:
        # missing types default to 0 (untyped), surplus types are an error
        nv, nt = len(self.add_vertices), len(self.vertex_types)
        if nt > nv:
            raise ValueError(
                f"vertex_types has {nt} entries for {nv} add_vertices; "
                "a type without a vertex is meaningless")
        if nt < nv:
            self.vertex_types = np.concatenate(
                [np.asarray(self.vertex_types, np.int32),
                 np.zeros(nv - nt, np.int32)])

    @property
    def size(self) -> int:
        return (len(self.add_src) + len(self.del_src) + len(self.add_vertices))


@dataclasses.dataclass
class _BatchDelta:
    """Per-batch ingestion record: which store rows the batch touched.
    Lets ``join_view`` enumerate a version delta in O(|delta|)."""
    version: int                # packed
    row_start: int              # appended rows: [row_start, row_end)
    row_end: int
    del_rows: np.ndarray        # rows tombstoned by this batch


@dataclasses.dataclass
class JoinView:
    """CSR of one snapshot: dst-grouped in-edges (the join view).

    Rows are in canonical (dst, src) order. The tensors live on the store's
    device with the reference's dtypes (int32 CSR, float32 degrees); the
    trailing ``np_*`` fields are host-side state for O(delta) incremental
    maintenance.
    """
    version: Version
    n: int
    offsets: torch.Tensor      # (n+1,) int32
    src: torch.Tensor          # (m,) int32 source vertex per in-edge
    dst: torch.Tensor          # (m,) int32
    out_degree: torch.Tensor   # (n,) float32
    in_degree: torch.Tensor    # (n,) float32
    np_keys: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)    # (m,) int64 (dst<<32)|src, ascending
    np_src: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    np_dst: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    np_in_deg: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)    # (n,) int64
    np_out_deg: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)    # (n,) int64

    @property
    def m(self) -> int:
        return int(self.src.shape[0])


def _edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    return (dst.astype(np.int64) << 32) | src.astype(np.int64)


def prune_views(views: dict, budget: int) -> int:
    """Drop cached views down to the :func:`ladder_keep` retention set,
    in place. Shared by the single store and the sharded stitched cache so
    the retention policy cannot diverge. Returns the number dropped."""
    if len(views) <= budget:
        return 0
    keep = set(ladder_keep(sorted(views, reverse=True), budget))
    drop = [k for k in views if k not in keep]
    for k in drop:
        del views[k]
    return len(drop)


def prune_retired(views: dict, floor: int) -> int:
    """Drop cached entries with version key < ``floor`` — but only once an
    entry at or above the floor exists, so the newest pre-floor entry keeps
    serving (and warm-starting) until the successor it waits on is cached.

    The sharded store uses this after a re-sharding migration: entries
    below the active routing plan's activation version were built under a
    retired plan and will never be served again once the first post-cutover
    snapshot exists. Returns the number dropped.
    """
    if floor <= 0 or not any(k >= floor for k in views):
        return 0
    drop = [k for k in views if k < floor]
    for k in drop:
        del views[k]
    return len(drop)


def _device_tensor(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    # always a copy: a view's tensors never alias the host arrays it keeps
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device,
                                                              copy=True)


def build_join_view(version: Version, n: int, keys, src_s, dst_s,
                    in_deg, out_deg, *, device=DEFAULT_DEVICE) -> JoinView:
    """Assemble a JoinView from canonical (dst, src)-ordered rows + degree
    arrays. Shared by the single store, the delta patcher, and the sharded
    stitcher so all three produce byte-identical CSRs.

    The CSR tensors carry the reference's dtypes: int32 offsets/src/dst
    (the reference's int64 offsets narrow to int32 in ``jnp.asarray``)
    and float32 degrees."""
    device = resolve_device(device)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(in_deg, out=offsets[1:])
    return JoinView(version, n, _device_tensor(offsets, np.int32, device),
                    _device_tensor(src_s, np.int32, device),
                    _device_tensor(dst_s, np.int32, device),
                    _device_tensor(out_deg, np.float32, device),
                    _device_tensor(in_deg, np.float32, device),
                    np_keys=keys, np_src=src_s, np_dst=dst_s,
                    np_in_deg=np.asarray(in_deg, np.int64),
                    np_out_deg=np.asarray(out_deg, np.int64))


def ladder_keep(keys_desc: list[int], budget: int) -> list[int]:
    """Pick which cached view versions to retain under a budget: a
    version-spaced ladder rather than the newest K.

    With delta maintenance the best rebuild base is the *nearest older*
    view, so newest-K retention leaves every pre-window version with no
    nearby base (ROADMAP: churn-adaptive view GC). Retention is an
    exponential histogram over distance-from-newest: bucket j spans
    distances [d·2^j, d·2^(j+1)) where d is the gap to the second-newest
    view, and the nearest view per bucket is kept, for at most
    ``budget - 1`` buckets. Any version inside the span then has a
    retained base within ~2x its distance from the frontier, and —
    crucially for repeated GC under a live stream — views beyond the last
    rung are dropped no matter what, so the retained set (and the
    ingestion delta log floored at its minimum) tracks the frontier
    instead of pinning the oldest view forever. ``budget`` is a cap (a
    bucket can swallow several views, so fewer may be retained).

    ``keys_desc`` must be sorted descending; returns the retained subset
    (descending). The two newest entries are always kept, so budget 2
    degenerates to newest-2 exactly.
    """
    n = len(keys_desc)
    if budget <= 0 or n == 0:
        return []
    if budget >= n:
        return list(keys_desc)
    newest = keys_desc[0]
    d_min = max(newest - keys_desc[1], 1)
    keep = [newest]
    last_bucket = -1
    for k in keys_desc[1:]:
        bucket = ((newest - k) // d_min).bit_length() - 1
        if bucket > budget - 2:
            break                      # beyond the last rung: drop the tail
        if bucket > last_bucket and len(keep) < budget:
            keep.append(k)
            last_bucket = bucket
    return keep


class DynamicGraph:
    """Capacity-bounded versioned edge store + vertex table, with device
    mirrors of the edge stamps on ``device``."""

    def __init__(self, n_max: int, e_max: int,
                 churn_threshold: float = DEFAULT_CHURN_THRESHOLD, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.n_max = n_max
        self.e_max = e_max
        self.churn_threshold = churn_threshold
        self.src = np.zeros(e_max, np.int32)
        self.dst = np.zeros(e_max, np.int32)
        # version stamps live in the int32 data-plane packing natively
        # (MAXV = int32 max = 'never'); overflow is checked once per apply
        self.created = np.full(e_max, MAXV, np.int32)
        self.deleted = np.full(e_max, MAXV, np.int32)
        # device mirrors of created/deleted: apply keeps them in step in
        # O(batch); sync_stamp_mirrors re-copies them after a wholesale
        # stamp write (checkpoint restore)
        self._d_created = torch.full((e_max,), MAXV, dtype=torch.int32,
                                     device=self.device)
        self._d_deleted = torch.full((e_max,), MAXV, dtype=torch.int32,
                                     device=self.device)
        self.n_edges = 0
        self.v_created = np.full(n_max, MAXV, np.int32)
        self.v_type = np.zeros(n_max, np.int32)
        self.n_vertices = 0
        self.versions: list[Version] = []
        self._views: dict[int, JoinView] = {}
        # (src, dst) -> latest live row; _prev_live chains to the previous
        # live row with the same key (LIFO, matching "delete the newest
        # live duplicate" semantics). Pre-sized for e_max distinct keys at
        # <= 2/3 load so the steady-state stream never pays a rehash.
        self._index = LiveEdgeIndex(capacity=(e_max * 3 + 1) // 2)
        self._prev_live = np.full(e_max, -1, np.int64)
        self._batch_log: list[_BatchDelta] = []
        # records with version <= _log_floor have been trimmed (gc_views);
        # delta patching is only valid from bases at or above the floor
        self._log_floor = -1
        # telemetry for the delta-view path (benchmarks read these)
        self.view_full_builds = 0
        self.view_delta_patches = 0

    # -- ingestion ---------------------------------------------------------
    def apply(self, batch: MutationBatch) -> None:
        v = batch.version.pack()
        if self.versions and v <= self.versions[-1].pack():
            raise ValueError("mutation batches must have increasing versions")
        # the single overflow check of the int32-native stamp plane; raises
        # (like the capacity check below) before any state mutates
        v32 = pack32_checked(batch.version)
        if self.n_edges + len(batch.add_src) > self.e_max:
            # checked before any state mutates so a failed apply is a no-op
            raise MemoryError("edge capacity exceeded")
        # a view cached for a future version is invalidated by this batch
        stale = [k for k in self._views if k >= v]
        for k in stale:
            del self._views[k]
        # vertex adds (typed): first occurrence per id wins within a batch
        # (lengths are normalized by MutationBatch.__post_init__)
        if len(batch.add_vertices):
            vids, first = np.unique(batch.add_vertices, return_index=True)
            new = self.v_created[vids] == MAXV
            vids, first = vids[new], first[new]
            self.v_created[vids] = v32
            self.v_type[vids] = batch.vertex_types[first]
            self.n_vertices += len(vids)
        # edge adds: append rows
        k = len(batch.add_src)
        row_start = self.n_edges
        if k:
            sl = slice(self.n_edges, self.n_edges + k)
            self.src[sl] = batch.add_src
            self.dst[sl] = batch.add_dst
            self.created[sl] = v32
            self.deleted[sl] = MAXV
            self._d_created[sl] = v32
            self._d_deleted[sl] = MAXV
            # auto-create endpoint vertices (untyped). Large batches use a
            # boolean scatter over the vertex table (O(n_max), but plain
            # ufunc/scatter passes); small batches on a large store keep
            # the O(k log k) unique+gather so a serving-tail delta never
            # pays a full vertex-table scan
            if 4 * k >= self.n_max:
                touched = np.zeros(self.n_max, bool)
                touched[batch.add_src] = True
                touched[batch.add_dst] = True
                touched &= self.v_created == MAXV
                self.v_created[touched] = v32
                self.n_vertices += int(np.count_nonzero(touched))
            else:
                ends = np.unique(np.concatenate([batch.add_src,
                                                 batch.add_dst]))
                new = ends[self.v_created[ends] == MAXV]
                self.v_created[new] = v32
                self.n_vertices += len(new)
            # push the new rows onto their keys' live stacks, whole-batch:
            # a stable key sort groups duplicates in arrival order, so each
            # duplicate chains to its predecessor in the run; one fused
            # probe pass (push) then swaps each key's previous top out —
            # run heads chain to it — and its run tail (newest dup) in
            rows = np.arange(row_start, row_start + k, dtype=np.int64)
            keys = _edge_keys(batch.add_src, batch.add_dst)
            order = np.argsort(keys, kind="stable")
            sk, sr = keys[order], rows[order]
            head = np.r_[True, sk[1:] != sk[:-1]]
            dup = np.flatnonzero(~head)
            self._prev_live[sr[dup]] = sr[dup - 1]
            tail = np.r_[head[1:], True]
            self._prev_live[sr[head]] = self._index.push(sk[head], sr[tail])
            self.n_edges += k
        # edge deletes: pop the newest live row matching (src, dst) —
        # batched. Duplicated delete keys pop successive stack entries:
        # round t tombstones the t-th duplicate of every key that still
        # has a live row, walking the prev-live chains one hop per round
        # (rounds = max per-key duplication, typically 1).
        del_rows = np.zeros(0, np.int64)
        if len(batch.del_src):
            dkeys = _edge_keys(batch.del_src, batch.del_dst)
            order = np.argsort(dkeys, kind="stable")
            sk = dkeys[order]
            head = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            uk = sk[head]
            counts = np.diff(np.r_[head, len(sk)])
            # one probe pass resolves each key's slot; the new tops are
            # written straight back to those slots (no inserts happen in
            # between, so the slots stay valid)
            slots = self._index.slots_of(uk)
            top = self._index.rows_at(slots)
            popped = top >= 0          # keys with no live row: ignore (seed)
            cur = top
            parts = []
            t = 0
            while True:
                act = (cur >= 0) & (counts > t)
                if not act.any():
                    break
                rows_t = cur[act]
                self.deleted[rows_t] = v32
                parts.append(rows_t)
                cur[act] = self._prev_live[rows_t]
                t += 1
            if parts:
                del_rows = np.concatenate(parts)
                self._d_deleted[torch.from_numpy(del_rows).to(
                    self.device)] = v32
            if popped.any():
                self._index.set_rows(slots[popped], cur[popped])
        self._batch_log.append(_BatchDelta(
            v, row_start, self.n_edges, del_rows))
        self.versions.append(batch.version)

    def sync_stamp_mirrors(self) -> None:
        """Re-copy the device stamp mirrors from the host arrays. Call after
        writing ``created``/``deleted`` wholesale (the sharded store's
        checkpoint restore); ``apply`` keeps them in step by itself."""
        e = self.e_max
        self._d_created.copy_(torch.from_numpy(self.created[:e]))
        self._d_deleted.copy_(torch.from_numpy(self.deleted[:e]))

    def _rebuild_index(self) -> None:
        """Rebuild the live-edge hash index and prev-live chains from the
        stamp arrays — the crash-recovery path after a checkpoint restores
        ``src``/``dst``/``created``/``deleted`` wholesale.

        Correctness: pushes happen in row order and a delete always pops
        the newest live duplicate, so a key's live stack is at every
        moment an ascending run of row ids — the live rows in ascending
        order ARE the stack bottom-to-top. Re-pushing them with the
        apply path's stable-sort chaining therefore reproduces the index
        state the uncrashed store would hold (dead rows' stale chain
        entries are unobservable: only live rows are ever walked).
        """
        self._index = LiveEdgeIndex(capacity=(self.e_max * 3 + 1) // 2)
        self._prev_live = np.full(self.e_max, -1, np.int64)
        e = self.n_edges
        live = np.flatnonzero(self.deleted[:e] == MAXV)
        if not live.size:
            return
        keys = _edge_keys(self.src[live], self.dst[live])
        order = np.argsort(keys, kind="stable")
        sk, sr = keys[order], live[order]
        head = np.r_[True, sk[1:] != sk[:-1]]
        dup = np.flatnonzero(~head)
        self._prev_live[sr[dup]] = sr[dup - 1]
        tail = np.r_[head[1:], True]
        self._prev_live[sr[head]] = self._index.push(sk[head], sr[tail])

    # -- snapshots -----------------------------------------------------------
    def snapshot_mask(self, version: Version,
                      use_kernel: Optional[bool] = None) -> np.ndarray:
        """created <= v < deleted — the paper's snapshot rule on edges, as a
        host bool array.

        Runs ``liveness_mask`` on the device stamp mirrors in place: the
        CUDA kernel on a CUDA store, the plain version on a CPU store
        (``use_kernel`` overrides, see :mod:`repro_torch.kernels.ops`).
        Only the mask comes back to the host.
        """
        v32 = pack32_clamped(version)
        e = self.n_edges
        mask = ops.liveness_mask(self._d_created[:e], self._d_deleted[:e],
                                 v32, use_kernel=use_kernel)
        return to_host(mask)

    def num_vertices(self, version: Optional[Version] = None) -> int:
        if version is None:
            return self.n_vertices
        return int((self.v_created <= pack32_clamped(version)).sum())

    def join_view(self, version: Version,
                  use_kernel: Optional[bool] = None) -> JoinView:
        """Return (and cache) the dst-grouped CSR for a snapshot.

        Prefers patching the newest cached view at an earlier version with
        the mutation delta; falls back to a full rebuild when no usable base
        exists or the delta exceeds the churn threshold.
        """
        key = version.pack()
        if key in self._views:
            return self._views[key]
        view = self._delta_patch(key, version)
        if view is None:
            view = self._full_rebuild(version, use_kernel=use_kernel)
            self.view_full_builds += 1
        else:
            self.view_delta_patches += 1
        self._views[key] = view
        return view

    def _full_rebuild(self, version: Version,
                      use_kernel: Optional[bool] = None) -> JoinView:
        mask = self.snapshot_mask(version, use_kernel=use_kernel)
        src = self.src[:self.n_edges][mask]
        dst = self.dst[:self.n_edges][mask]
        keys = _edge_keys(src, dst)
        order = np.argsort(keys, kind="stable")
        return self._make_view(version, keys[order], src[order], dst[order],
                               np.bincount(dst, minlength=self.n_max),
                               np.bincount(src, minlength=self.n_max))

    def _make_view(self, version: Version, keys, src_s, dst_s,
                   in_deg, out_deg) -> JoinView:
        return build_join_view(version, self.n_max, keys, src_s, dst_s,
                               in_deg, out_deg, device=self.device)

    def _delta_patch(self, key: int, version: Version) -> Optional[JoinView]:
        """Patch the newest cached view with version < key, or None if no
        base is usable / the churn threshold is exceeded."""
        bases = [k for k in self._views if self._log_floor <= k < key
                 and self._views[k].np_keys is not None]
        if not bases:
            return None
        base_key = max(bases)
        base = self._views[base_key]
        # edge delta between base_key and key: the log is version-sorted,
        # so the record range is found by bisection — O(|delta| + log B)
        lo = bisect.bisect_right(self._batch_log, base_key,
                                 key=lambda r: r.version)
        hi = bisect.bisect_right(self._batch_log, key,
                                 key=lambda r: r.version)
        add_rows: list[np.ndarray] = []
        del_rows: list[np.ndarray] = []
        for rec in self._batch_log[lo:hi]:
            add_rows.append(np.arange(rec.row_start, rec.row_end, dtype=np.int64))
            del_rows.append(rec.del_rows)
        adds = (np.concatenate(add_rows) if add_rows
                else np.zeros(0, np.int64))
        dels = (np.concatenate(del_rows) if del_rows
                else np.zeros(0, np.int64))
        # rows added in the delta count only if still live at `key`; rows
        # deleted in the delta count only if present in the base (a row both
        # added and deleted inside the delta cancels out of both sets).
        # Stamp arrays are int32-packed, so the 64-bit log/cache keys are
        # re-expressed in stamp packing for the comparisons.
        adds = adds[self.deleted[adds] > pack32_clamped(version)]
        dels = dels[self.created[dels]
                    <= pack32_clamped(Version.unpack(base_key))]
        churn = len(adds) + len(dels)
        if churn > self.churn_threshold * max(base.m, 1):
            return None
        if churn == 0:
            return self._make_view(version, base.np_keys, base.np_src,
                                   base.np_dst, base.np_in_deg.copy(),
                                   base.np_out_deg.copy())
        keys, src_s, dst_s = base.np_keys, base.np_src, base.np_dst
        in_deg = base.np_in_deg.copy()
        out_deg = base.np_out_deg.copy()
        if len(dels):
            dkeys = np.sort(_edge_keys(self.src[dels], self.dst[dels]))
            # multiset removal: j-th duplicate of a key removes the j-th of
            # its contiguous run in the (sorted) base rows
            left = np.searchsorted(keys, dkeys, side="left")
            occ = np.arange(len(dkeys)) - np.searchsorted(dkeys, dkeys,
                                                          side="left")
            keep = np.ones(len(keys), bool)
            keep[left + occ] = False
            keys, src_s, dst_s = keys[keep], src_s[keep], dst_s[keep]
            np.subtract.at(in_deg, self.dst[dels], 1)
            np.subtract.at(out_deg, self.src[dels], 1)
        if len(adds):
            asrc, adst = self.src[adds], self.dst[adds]
            akeys = _edge_keys(asrc, adst)
            order = np.argsort(akeys, kind="stable")
            akeys, asrc, adst = akeys[order], asrc[order], adst[order]
            pos = np.searchsorted(keys, akeys, side="left")
            keys = np.insert(keys, pos, akeys)
            src_s = np.insert(src_s, pos, asrc)
            dst_s = np.insert(dst_s, pos, adst)
            np.add.at(in_deg, adst, 1)
            np.add.at(out_deg, asrc, 1)
        return self._make_view(version, keys, src_s, dst_s, in_deg, out_deg)

    def gc_views(self, keep_latest: int = 4, *, retire_below: int = 0) -> int:
        """Collect obsolete join views (paper §2.2 obsolete-replica GC).

        Retention is churn-adaptive: instead of the newest ``keep_latest``
        views, a version-spaced *ladder* (:func:`ladder_keep`) is kept, so a
        request for any past version finds a delta-patch base within ~2x its
        distance from the frontier under the same budget.

        ``retire_below`` additionally drops every cached view below that
        packed version once a newer one is cached (:func:`prune_retired`) —
        the sharded store passes a re-sharding migration's activation
        version here so a shard involved in a split does not pin pre-split
        views (built under a retired routing plan) in its ladder.

        Also trims the ingestion delta log: records at or below the oldest
        retained view's version can never contribute to a future delta
        patch from a retained base, so the log stays bounded by the churn
        since the oldest view instead of growing with the whole stream.
        The trim runs even when no view is dropped (with no cached views
        at all, everything up to the newest applied version is trimmed —
        any later-cached old view is then below the floor and rebuilds
        from scratch, never from missing records).

        The log floor additionally tracks ``retire_below`` *whether or not*
        :func:`prune_retired` fired: records strictly below the retired
        floor only patch retired-plan targets, and keeping them pinned the
        log to the oldest retired view whenever no post-cutover view was
        cached yet (e.g. a serving path that stalls right after a
        re-sharding split) — the one place view pruning and ``_log_floor``
        bookkeeping could disagree. Still-cached retired views remain
        addressable; they just full-rebuild instead of serving as delta
        bases.
        """
        dropped = prune_retired(self._views, retire_below)
        dropped += prune_views(self._views, keep_latest)
        if self._views:
            floor = min(self._views)
        elif self.versions:
            floor = self.versions[-1].pack()
        else:
            floor = self._log_floor
        # retire_below drops entries < floor, the log trim drops records
        # <= floor: records AT the retired floor (the cutover batch) stay
        floor = max(floor, retire_below - 1)
        self._batch_log = [r for r in self._batch_log if r.version > floor]
        self._log_floor = max(self._log_floor, floor)
        return dropped


# ----------------------------------------------------------- synthetic data
# The generators keep NumPy's ``default_rng`` and make the same rng calls in
# the same order as the reference's, so one seed gives the reference's
# batches exactly. The live/dead edge sets are NumPy arrays (the reference
# walks Python lists of tuples, which does not scale to device-sized
# streams); order is preserved everywhere the rng's indices point into.

def _remove_at(live_s: np.ndarray, live_d: np.ndarray,
               idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keep = np.ones(len(live_s), bool)
    keep[idx] = False
    return live_s[keep], live_d[keep]


def _churn_batches(rng, n_epochs: int, sample_adds, *, delete_frac: float,
                   readd_frac: float) -> list[MutationBatch]:
    """Shared epoch loop for the synthetic stream generators: per-epoch
    ``(src, dst)`` adds from ``sample_adds(rng)``, live-set bookkeeping,
    ``delete_frac`` uniform deletes and ``readd_frac`` re-adds of
    previously deleted edges. One implementation of the delete/re-add
    bookkeeping keeps the uniform and skewed generators in lockstep."""
    live_s = live_d = np.zeros(0, np.int32)
    dead_s = dead_d = np.zeros(0, np.int32)
    batches = []
    for e in range(n_epochs):
        src, dst = sample_adds(rng)
        adds_s = np.asarray(src, np.int32)
        adds_d = np.asarray(dst, np.int32)
        if readd_frac and len(dead_s):
            k = int(len(dead_s) * readd_frac)
            pick = rng.choice(len(dead_s), size=k, replace=False)
            adds_s = np.concatenate([adds_s, dead_s[pick]])
            adds_d = np.concatenate([adds_d, dead_d[pick]])
        n_del = int(len(live_s) * delete_frac)
        if n_del:
            idx = rng.choice(len(live_s), size=n_del, replace=False)
            del_s, del_d = live_s[idx], live_d[idx]
            live_s, live_d = _remove_at(live_s, live_d, idx)
            dead_s = np.concatenate([dead_s, del_s])
            dead_d = np.concatenate([dead_d, del_d])
        else:
            del_s = del_d = np.zeros(0, np.int32)
        live_s = np.concatenate([live_s, adds_s])
        live_d = np.concatenate([live_d, adds_d])
        batches.append(MutationBatch(
            Version(e, 0), add_src=adds_s, add_dst=adds_d,
            del_src=del_s, del_dst=del_d))
    return batches


def synthesize_churn_stream(n_vertices: int, n_epochs: int,
                            adds_per_epoch: int, *, seed: int = 0,
                            delete_frac: float = 0.0,
                            readd_frac: float = 0.0) -> list[MutationBatch]:
    """Uniform-random mutation batches with controllable churn: each epoch
    deletes ``delete_frac`` of the live edges and re-adds ``readd_frac`` of
    the previously deleted ones. Shared by the equivalence tests and the
    serving smoke run so both exercise identical stream semantics."""

    def sample_adds(rng):
        src = rng.integers(0, n_vertices, adds_per_epoch).astype(np.int32)
        dst = rng.integers(0, n_vertices, adds_per_epoch).astype(np.int32)
        return src, dst

    return _churn_batches(np.random.default_rng(seed), n_epochs, sample_adds,
                          delete_frac=delete_frac, readd_frac=readd_frac)


def synthesize_skewed_stream(n_vertices: int, n_epochs: int,
                             adds_per_epoch: int, *, seed: int = 0,
                             zipf_a: float = 1.2,
                             delete_frac: float = 0.0) -> list[MutationBatch]:
    """Zipf-skewed mutation batches: destination vertices are drawn from a
    Zipf(``zipf_a``) rank distribution mapped through a random permutation
    of the vertex ids, so a handful of (randomly placed) vertices receive
    most of the edges — the hot-shard regime the access-pattern-adaptive
    re-sharding planner exists for. Sources are uniform. ``delete_frac``
    deletes that fraction of the live edges each epoch (uniformly, so
    deletes of hot-destination edges exercise post-migration delete
    routing)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_vertices)

    def sample_adds(rng):
        ranks = rng.zipf(zipf_a, adds_per_epoch)
        dst = perm[(ranks - 1) % n_vertices].astype(np.int32)
        src = rng.integers(0, n_vertices, adds_per_epoch).astype(np.int32)
        return src, dst

    return _churn_batches(rng, n_epochs, sample_adds,
                          delete_frac=delete_frac, readd_frac=0.0)


def synthesize_stream(n_vertices: int, n_epochs: int, adds_per_epoch: int,
                      *, seed: int = 0, delete_frac: float = 0.05,
                      n_types: int = 3, device=DEFAULT_DEVICE
                      ) -> tuple[DynamicGraph, list[MutationBatch]]:
    """Preferential-attachment mutation stream (citation-graph-like: papers
    cite earlier papers; new vertex types appear in later epochs — the
    paper's Fig 1 evolution). Vertices grown in each epoch arrive as typed
    ``add_vertices`` with the epoch's type. The returned store lives on
    ``device``."""
    rng = np.random.default_rng(seed)
    e_max = n_epochs * adds_per_epoch * 2 + 16
    g = DynamicGraph(n_vertices, e_max, device=device)
    batches = []
    deg = np.ones(n_vertices, np.float64)
    grown = 8
    live_s = live_d = np.zeros(0, np.int32)
    for epoch in range(n_epochs):
        prev_grown = grown
        grown = min(n_vertices, grown + max(1, n_vertices // (n_epochs + 1)))
        p = deg[:grown] / deg[:grown].sum()
        dsts = rng.choice(grown, size=adds_per_epoch, p=p).astype(np.int32)
        srcs = rng.integers(0, grown, size=adds_per_epoch).astype(np.int32)
        keep = srcs != dsts
        srcs, dsts = srcs[keep], dsts[keep]
        deg_update = np.bincount(dsts, minlength=n_vertices)
        deg += deg_update
        n_del = int(len(live_s) * delete_frac)
        if n_del:
            idx = rng.choice(len(live_s), size=n_del, replace=False)
            del_src, del_dst = live_s[idx], live_d[idx]
            live_s, live_d = _remove_at(live_s, live_d, idx)
        else:
            del_src = del_dst = np.zeros(0, np.int32)
        live_s = np.concatenate([live_s, srcs])
        live_d = np.concatenate([live_d, dsts])
        # vertex type evolution: later epochs introduce new types; this
        # epoch's newly grown vertices carry the epoch's type (Fig 1)
        vtype = np.minimum(epoch * n_types // max(n_epochs, 1), n_types - 1)
        new_vertices = np.arange(0 if epoch == 0 else prev_grown, grown,
                                 dtype=np.int32)
        batch = MutationBatch(
            version=Version(epoch, 0),
            add_src=srcs, add_dst=dsts,
            del_src=del_src, del_dst=del_dst,
            add_vertices=new_vertices,
            vertex_types=np.full(len(new_vertices), vtype, np.int32))
        g.apply(batch)
        batches.append(batch)
    return g, batches
