"""Sharded dynamic-graph store — the paper's distributed data model on top
of the vectorized single store, with access-pattern-adaptive re-sharding.

See ``docs/ARCHITECTURE.md`` for the layer-by-layer map of the
ingest -> seal -> view -> query pipeline and the re-sharding correctness
argument; this docstring summarizes the store itself.

The evolving graph is distributed across ``core.snapshotter.DataNode``s,
one :class:`~repro_torch.graph.dyngraph.DynamicGraph` shard per node, with
mutations routed by **destination vertex** through a versioned
:class:`RoutingPlan` (plan 0 is the classic ``key % n_shards`` dst-hash).
Every edge (and every delete of it) lands on exactly one shard, so
shard-local LIFO delete semantics equal the global ones. Ingestion goes
through ``IngestNode.dispatch_batch`` with the encoded mutations riding
along as a payload: the paper's no-wait rule applies unchanged (a shard
whose local frontier lags parks its slice in ``blocked_batches``; healthy
shards keep ingesting), and a shard *applies* its slice inside
``DataNode.seal_epoch`` via the ``on_seal`` hook, so the local snapshot
and the shard store seal atomically.

Each shard maintains its own delta-patched join view over its slice;
:meth:`ShardedDynamicGraph.join_view` stitches the per-shard CSRs into a
global :class:`~repro_torch.graph.dyngraph.JoinView` that is byte-identical to
the single store's (per-shard rows are already in canonical (dst, src)
order and a key can only live on one shard, so a stable merge reproduces
the canonical global order exactly). The ``SnapshotCoordinator`` frontier
gates which epochs are queryable: a snapshot is only addressable once every
shard has sealed it, which is the paper's global-snapshot rule.

**Dynamic re-sharding** (paper §2.2: the data manager "improves data
locality thus can adapt to data access patterns of different algorithms"):
an :class:`AccessStats` ledger tracks per-shard load (mutation routing
counts plus query touches fed in by the serving layer). When the
:class:`~repro_torch.core.replica.ShardPlanner` flags a hot shard,
:meth:`ShardedDynamicGraph.split_shard` activates a successor
:class:`RoutingPlan` that splits the hot shard's key range in half
(consistent-hash style: one extra bit of a key hash), creates the new
shard, and migrates the moving half *as ordinary mutation payloads* — one
delete per moving live row dispatched to the source shard, one add to the
target — all stamped with the cutover version ``(activation_epoch, 0)``.
The migration therefore applies atomically when the activation epoch
seals, older snapshots keep resolving from the source shard's rows (their
delete stamps are the cutover version, which older masks exclude), and
``latest_sealed()`` views remain byte-identical to the single-store oracle
before, during, and after the cutover. Cutover requires a *quiescent*
store (frontier == every local frontier == last ingested epoch, nothing
parked), which the cooperative serving loop guarantees between epochs.

For distributed compute, :meth:`shard_views` exposes the pre-sharded
per-shard views directly — ``partition.partition_graph_sharded`` consumes
them without re-bucketing.

Thread-safety: like ``DynamicGraph``, this class is not internally
locked; the serving layer (``launch.serve_graph.GraphQueryServer``)
serializes every mutating touch behind one lock and runs query compute on
immutable stitched views outside it. ``parallel_apply`` adds an *internal*
apply plane below that discipline: ``seal_epoch`` fans the per-shard seals
out onto a persistent thread pool (shard state is disjoint, the store's
vectorized apply path releases the GIL inside its NumPy kernels) and
joins them before returning, so callers observe the same serial
semantics — one thread in, one thread out.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.replica import ShardPlanner
from repro_torch.core.snapshotter import DataNode, IngestNode, SnapshotCoordinator
from repro_torch.core.versioned import (Version, pack32_checked, pack32_clamped,
                                  unpack32)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.graph.dyngraph import (DEFAULT_CHURN_THRESHOLD, MAXV,
                                        DynamicGraph, JoinView, MutationBatch,
                                        build_join_view, prune_retired,
                                        prune_views, splitmix64)
from repro_torch.graph.wal import (FaultInjector, GraphCheckpointManager,
                                   GraphWal, ShardWal, scan_shard_records,
                                   truncate_shard_after)

# payload row kinds, in the order DynamicGraph.apply processes them
K_VERTEX, K_ADD, K_DEL = 0, 1, 2

_EMPTY_ROWS = np.zeros((0, 4), np.int32)

# the refinement hash consulted by RoutingPlan.assign for split bits:
# independent of the base ``key % n_base`` residue, so a split halves a
# shard's keys uniformly regardless of their residue structure (same
# SplitMix64 finalizer the live-edge index hashes slots with)
_mix64 = splitmix64


@dataclasses.dataclass(frozen=True)
class ShardLeaf:
    """One shard's key range under a :class:`RoutingPlan`.

    A key belongs to this leaf iff ``key % n_base == residue`` and the low
    ``depth`` bits of ``_mix64(key)`` equal ``path``. Every shard owns
    exactly one leaf (splits append a new shard for the new half-range),
    and the leaves tile the key space: each key matches exactly one leaf.
    """
    shard: int
    residue: int
    depth: int
    path: int


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Versioned key->shard assignment with consistent-hash range splits
    and merges.

    Plan 0 (:meth:`initial`) reproduces the static dst-hash
    exactly: shard ``i`` owns ``key % n_base == i`` at depth 0. Each
    :meth:`split` derives the successor plan: the hot shard's leaf gains
    one refinement bit (bit value 0 stays), and a NEW shard
    (id = :attr:`n_total`, the physical allocation counter) takes the
    bit-1 half — so only the migrating half-range moves and every other
    shard's assignment is untouched. :meth:`merge` is the inverse: a cold
    leaf's whole range folds back into its *sibling* (the leaf it was
    split from, or that was split from it), the merged leaf loses one
    refinement bit, and the merged-away shard owns nothing under the
    successor plan (the store retires it in place — shard ids are
    positional and never reused, which is why ``n_total`` does not shrink).

    Plans are immutable; ``history`` records every re-sharding event as
    ``("split", hot, new, activation_epoch)`` /
    ``("merge", survivor, removed, activation_epoch)`` so :meth:`replay`
    reproduces any plan deterministically (property-tested in
    ``tests/test_resharding.py``). ``activation_epoch`` is the first epoch
    routed by this plan — mutations of earlier epochs were routed (and
    applied) under the predecessor.
    """
    plan_id: int
    activation_epoch: int
    n_base: int
    leaves: tuple[ShardLeaf, ...]
    n_total: int = 0
    history: tuple[tuple[str, int, int, int], ...] = ()

    def __post_init__(self):
        if self.n_total < len(self.leaves):   # hand-built plan: every leaf
            object.__setattr__(self, "n_total",  # owner was once allocated
                               1 + max(leaf.shard for leaf in self.leaves))

    @classmethod
    def initial(cls, n_shards: int) -> "RoutingPlan":
        """Plan 0: the static ``key % n_shards`` dst-hash route."""
        return cls(0, 0, n_shards,
                   tuple(ShardLeaf(i, i, 0, 0) for i in range(n_shards)),
                   n_shards)

    @classmethod
    def replay(cls, n_base: int,
               history: tuple[tuple[str, int, int, int], ...]
               ) -> "RoutingPlan":
        """Rebuild the plan a split/merge history produced. Deterministic:
        the same history always yields the same leaves, hence the same
        assignment for every key."""
        plan = cls.initial(n_base)
        for op, a, b, activation in history:
            if op == "split":
                plan = plan.split(a, activation)
                if plan.leaves[-1].shard != b:
                    raise ValueError(
                        f"history names new shard {b} but replay "
                        f"produced {plan.leaves[-1].shard}")
            elif op == "merge":
                if plan.sibling_of(b) != a:
                    raise ValueError(
                        f"history merges shard {b} into {a} but its "
                        f"sibling under replay is {plan.sibling_of(b)}")
                plan = plan.merge(b, activation)
            else:
                raise ValueError(f"unknown history op {op!r}")
        return plan

    @property
    def n_shards(self) -> int:
        """LIVE shard count (leaves in the plan). After a merge this is
        smaller than ``n_total``, the physical shards the store holds."""
        return len(self.leaves)

    def leaf_of(self, shard: int) -> ShardLeaf:
        """The leaf ``shard`` owns, or ``ValueError`` if it owns none
        (merged away, or never allocated)."""
        for leaf in self.leaves:
            if leaf.shard == shard:
                return leaf
        raise ValueError(f"shard {shard} owns no leaf under plan "
                         f"{self.plan_id} (retired or never allocated)")

    def sibling_of(self, shard: int) -> Optional[int]:
        """The shard owning ``shard``'s sibling leaf — same residue, same
        depth, paths differing only in the top refinement bit — or None
        when no such leaf exists (depth 0, or the sibling range was split
        further). Merging is only defined between siblings: their union
        is exactly one depth-1 leaf."""
        leaf = self.leaf_of(shard)
        if leaf.depth == 0:
            return None
        want = leaf.path ^ (1 << (leaf.depth - 1))
        for other in self.leaves:
            if (other.residue == leaf.residue and other.depth == leaf.depth
                    and other.path == want):
                return other.shard
        return None

    def mergeable_pairs(self) -> list[tuple[int, int]]:
        """Current sibling pairs as ``(survivor, removed)`` candidates,
        bit-0 half first (the shard a split kept) — the planner's merge
        menu. Deterministic order (by survivor id)."""
        pairs = []
        for leaf in self.leaves:
            if leaf.depth > 0 and not leaf.path & (1 << (leaf.depth - 1)):
                sib = self.sibling_of(leaf.shard)
                if sib is not None:
                    pairs.append((leaf.shard, sib))
        return sorted(pairs)

    def _table(self) -> tuple[np.ndarray, int]:
        """Dense ``(residue, low-D refinement bits) -> shard`` lookup,
        built once per (immutable) plan and cached on the instance. D is
        the deepest leaf's depth; a leaf at depth d owns every table entry
        whose low d bits match its path, so the leaves tile each residue's
        2^D entries exactly."""
        cached = getattr(self, "_tbl", None)
        if cached is None:
            depth = max(leaf.depth for leaf in self.leaves)
            table = np.full((self.n_base, 1 << depth), -1, np.int64)
            for leaf in self.leaves:
                table[leaf.residue, leaf.path::1 << leaf.depth] = leaf.shard
            assert (table >= 0).all(), "leaves do not tile the key space"
            # flattened for the 1-D gather in assign: row-major means the
            # flat index is (residue << depth) | refinement_bits
            cached = (table.ravel(), depth)
            object.__setattr__(self, "_tbl", cached)   # frozen dataclass
        return cached

    def assign(self, keys) -> np.ndarray:
        """Vectorized key->shard assignment under this plan.

        Accepts a scalar (returns int — the ``IngestNode.dispatch`` scalar
        path) or an array (returns an int64 array of the same shape).
        Every key matches exactly one leaf, so the result is total. One
        gather through the cached leaf table instead of a per-leaf mask
        pass — on an unsplit plan this is a single ``%`` ufunc."""
        arr = np.asarray(keys)
        scalar = arr.ndim == 0
        k = np.atleast_1d(arr).astype(np.int64)
        table, depth = self._table()
        if depth == 0:
            out = k % self.n_base
        else:
            h = _mix64(k) & np.uint64((1 << depth) - 1)
            out = table[((k % self.n_base) << depth)
                        | h.view(np.int64)]
        return int(out[0]) if scalar else out

    def split(self, hot_shard: int, activation_epoch: int) -> "RoutingPlan":
        """Successor plan: halve ``hot_shard``'s range, giving the bit-1
        half to a new shard (id = ``n_total``, the next physical slot)."""
        leaf = self.leaf_of(hot_shard)
        new_shard = self.n_total
        leaves = list(self.leaves)
        leaves[leaves.index(leaf)] = ShardLeaf(hot_shard, leaf.residue,
                                               leaf.depth + 1, leaf.path)
        leaves.append(ShardLeaf(new_shard, leaf.residue, leaf.depth + 1,
                                leaf.path | (1 << leaf.depth)))
        return RoutingPlan(
            self.plan_id + 1, activation_epoch, self.n_base, tuple(leaves),
            self.n_total + 1,
            self.history + (("split", hot_shard, new_shard,
                             activation_epoch),))

    def merge(self, removed_shard: int,
              activation_epoch: int) -> "RoutingPlan":
        """Successor plan: fold ``removed_shard``'s whole range into its
        sibling's leaf, which loses one refinement bit. The removed shard
        owns nothing afterwards; ``n_total`` is unchanged (shard ids are
        never reused). Raises ``ValueError`` when the leaf has no sibling
        (depth 0, or the sibling range was split further — coarsening can
        only un-do a split)."""
        survivor = self.sibling_of(removed_shard)
        if survivor is None:
            raise ValueError(
                f"shard {removed_shard} has no sibling leaf under plan "
                f"{self.plan_id}; only split halves can merge back")
        gone = self.leaf_of(removed_shard)
        kept = self.leaf_of(survivor)
        merged = ShardLeaf(survivor, kept.residue, kept.depth - 1,
                           kept.path & ((1 << (kept.depth - 1)) - 1))
        leaves = list(self.leaves)
        leaves[leaves.index(kept)] = merged
        leaves.remove(gone)
        return RoutingPlan(
            self.plan_id + 1, activation_epoch, self.n_base, tuple(leaves),
            self.n_total,
            self.history + (("merge", survivor, removed_shard,
                             activation_epoch),))


class AccessStats:
    """Per-shard load ledger: the planner's observation window.

    Two exponentially-decayed counters per shard — ``mutations`` (rows
    routed there at ingest) and ``queries`` (query touch vertices the
    serving layer reports via
    :meth:`ShardedDynamicGraph.record_query_touches`). ``loads()`` is
    their weighted sum; the decay is applied once per globally-sealed
    epoch, so the window tracks recent epochs and a formerly-hot shard
    cools off. ``epochs_observed`` counts sealed epochs since the last
    :meth:`reset` (splits reset the ledger — fresh plan, fresh window —
    which doubles as the planner's cooldown clock).

    With ``n_vertices > 0`` the ledger additionally keeps a per-VERTEX
    EWMA of query touches (``vertex_heat``) — the replica plane's
    nomination signal: the hottest query anchors get their adjacency
    mirrored (``core.replica.MirrorPlanner`` turns this vector into the
    mirror set). Vertex heat decays on the same per-epoch tick as the
    shard counters but survives :meth:`reset`: a routing-plan change
    re-bins shard loads, it does not change which *vertices* are hot.
    """

    def __init__(self, n_shards: int, *, decay: float = 0.5,
                 query_weight: float = 1.0, n_vertices: int = 0):
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        self.decay = decay
        self.query_weight = query_weight
        self.mutations = np.zeros(n_shards, np.float64)
        self.queries = np.zeros(n_shards, np.float64)
        self.vertex_heat = np.zeros(int(n_vertices), np.float64)
        self.epochs_observed = 0
        self._last_frontier = -1

    def record_mutations(self, counts: np.ndarray) -> None:
        self.mutations += counts

    def record_queries(self, counts: np.ndarray) -> None:
        self.queries += counts

    def record_vertex_touches(self, vertex_ids) -> None:
        """Per-vertex heat feed (query anchors; ids outside [0, n) are
        ignored — a query may name a vertex that does not exist yet)."""
        if not self.vertex_heat.size:
            return
        ids = np.asarray(vertex_ids, np.int64)
        ids = ids[(ids >= 0) & (ids < self.vertex_heat.size)]
        if ids.size:
            self.vertex_heat += np.bincount(
                ids, minlength=self.vertex_heat.size)

    def on_frontier_advance(self, frontier: int) -> None:
        """Decay tick, one per newly-sealed EPOCH. A straggler catching up
        can move the global frontier several epochs in one advance (one
        subscriber notification), so the tick is driven by the frontier
        value, not the notification count — otherwise multi-epoch
        advances would under-decay the window and stretch the planner's
        cooldown."""
        epochs = frontier - self._last_frontier
        if epochs <= 0:
            return
        self._last_frontier = frontier
        self.epochs_observed += epochs
        if self.decay < 1.0:
            self.mutations *= self.decay ** epochs
            self.queries *= self.decay ** epochs
            if self.vertex_heat.size:
                self.vertex_heat *= self.decay ** epochs

    def loads(self) -> np.ndarray:
        """Per-shard load vector the planner scores."""
        return self.mutations + self.query_weight * self.queries

    def reset(self, n_shards: int) -> None:
        """Start a fresh observation window (sized for ``n_shards``).
        The frontier watermark and the vertex-heat vector are global
        state, not window state, so both survive the reset — a plan
        change re-bins shard loads without cooling hot vertices."""
        self.mutations = np.zeros(n_shards, np.float64)
        self.queries = np.zeros(n_shards, np.float64)
        self.epochs_observed = 0


def encode_payload_rows(batch: MutationBatch) -> np.ndarray:
    """A batch's ``(kind, a, b, packed32_version)`` int32 payload rows —
    the byte-stable unit the dispatch payloads and the write-ahead log
    (``graph/wal.py``) share. Row order is vertices, then edge adds, then
    deletes: the order ``DynamicGraph.apply`` processes a batch, so
    ``decode_payloads(encode_payload_rows(b))`` reproduces ``b`` exactly —
    field for field, element for element.

    The version column uses the same order-preserving int32 data-plane
    packing as the stamp arrays (checked here, ahead of any ingest
    bookkeeping), which halves the payload bytes moved per row through
    dispatch grouping and decode.

    Raises ``ValueError`` if ``add_vertices`` and ``vertex_types`` disagree
    in length (a batch mutated after construction, bypassing
    ``MutationBatch.__post_init__``).
    """
    v = pack32_checked(batch.version)
    # MutationBatch.__post_init__ pads/validates, so the two arrays agree by
    # construction; a hand-built batch that bypassed it fails loudly here
    # instead of silently dropping vertex adds on the sharded path only
    n_typed = len(batch.add_vertices)
    if len(batch.vertex_types) != n_typed:
        raise ValueError(
            f"add_vertices ({n_typed}) and vertex_types "
            f"({len(batch.vertex_types)}) disagree in length")
    n_add = len(batch.add_src)
    n_del = len(batch.del_src)
    total = n_typed + n_add + n_del
    if not total:
        return _EMPTY_ROWS
    payload = np.empty((total, 4), np.int32)
    payload[:, 3] = v
    payload[:n_typed, 0] = K_VERTEX
    payload[:n_typed, 1] = batch.add_vertices
    payload[:n_typed, 2] = batch.vertex_types
    a = n_typed + n_add
    payload[n_typed:a, 0] = K_ADD
    payload[n_typed:a, 1] = batch.add_src
    payload[n_typed:a, 2] = batch.add_dst
    payload[a:, 0] = K_DEL
    payload[a:, 1] = batch.del_src
    payload[a:, 2] = batch.del_dst
    return payload


def encode_mutations(batch: MutationBatch) -> tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Flatten a MutationBatch into (keys, epochs, payload) for
    ``IngestNode.dispatch_batch``.

    keys are the routing keys (dst for edges, the vertex id for vertex
    adds); payload rows come from :func:`encode_payload_rows` (which also
    carries the malformed-batch and version-overflow checks).
    """
    payload = encode_payload_rows(batch)
    total = len(payload)
    if not total:
        z = np.zeros(0, np.int64)
        return z, z, payload
    n_typed = len(batch.add_vertices)
    n_add = len(batch.add_src)
    a = n_typed + n_add
    key_arr = np.empty(total, np.int64)
    key_arr[:n_typed] = batch.add_vertices      # vertex id routes home
    key_arr[n_typed:a] = batch.add_dst
    key_arr[a:] = batch.del_dst
    epochs = np.full(total, batch.version.epoch, np.int64)
    return key_arr, epochs, payload


def decode_payloads(payloads: list[np.ndarray]) -> list[MutationBatch]:
    """Reassemble a shard's payload rows (arrival order) into per-version
    MutationBatches, preserving within-batch mutation order.

    Rows of the same packed version — e.g. a re-sharding migration slice
    and a user batch that share the cutover version — merge into ONE batch
    in arrival order, which is exactly the single store's apply order for
    that version.
    """
    if not payloads:
        return []
    rows = np.concatenate(payloads, axis=0) if len(payloads) > 1 \
        else payloads[0]
    out = []
    vcol = rows[:, 3]
    # stable group-by on the packed version: np.unique yields versions in
    # ascending (= apply) order and the boolean mask preserves within-version
    # arrival order, so a straggler shard replaying several parked slices in
    # one seal — possibly interleaved across versions — still reassembles
    # each batch intact. (The old fast path trusted rows[0] == rows[-1],
    # which an interleaved replay defeats.) Common case: one version per
    # seal, detected with a full scan, not an endpoint check.
    if (vcol == vcol[0]).all():
        versions = vcol[:1]
    else:
        versions = np.unique(vcol)
    for v in versions:
        grp = rows if len(versions) == 1 else rows[vcol == v]
        kind, a, b = grp[:, 0], grp[:, 1], grp[:, 2]
        vert = kind == K_VERTEX
        add = kind == K_ADD
        dele = kind == K_DEL
        out.append(MutationBatch(
            unpack32(int(v)),
            add_src=a[add].astype(np.int32, copy=False),
            add_dst=b[add].astype(np.int32, copy=False),
            del_src=a[dele].astype(np.int32, copy=False),
            del_dst=b[dele].astype(np.int32, copy=False),
            add_vertices=a[vert].astype(np.int32, copy=False),
            vertex_types=b[vert].astype(np.int32, copy=False)))
    return out


def _merge_same_version(batches: list[MutationBatch]) -> list[MutationBatch]:
    """Fold adjacent same-version batches (version-sorted input) into one
    by field concatenation — the in-arrival-order row merge
    ``decode_payloads`` performs for encoded rows, lifted to whole
    batches. ``DynamicGraph.apply`` rejects repeated versions, so rows of
    one version MUST reach it as one batch."""
    out: list[MutationBatch] = []
    for b in batches:
        if out and out[-1].version == b.version:
            a = out[-1]
            out[-1] = MutationBatch(
                a.version,
                add_src=np.concatenate([a.add_src, b.add_src]),
                add_dst=np.concatenate([a.add_dst, b.add_dst]),
                del_src=np.concatenate([a.del_src, b.del_src]),
                del_dst=np.concatenate([a.del_dst, b.del_dst]),
                add_vertices=np.concatenate([a.add_vertices,
                                             b.add_vertices]),
                vertex_types=np.concatenate([a.vertex_types,
                                             b.vertex_types]))
        else:
            out.append(b)
    return out


class _ShardSlice:
    """Deferred per-shard slice of one ingested MutationBatch.

    The steady-state ingest fast path routes ONCE (``node_ids`` over the
    concatenated routing keys), groups with one stable GIL-releasing
    argsort, and hands every shard one of these — its ascending original
    row positions across the batch's three sections (typed vertex adds,
    edge adds, edge deletes) — instead of encoding payload rows and
    gathering a slice per shard on the ingest thread. :meth:`materialize`
    — called inside the shard's seal, i.e. on the parallel apply plane —
    splits the positions at the section boundaries (O(log) searchsorted;
    a stable sort keeps them ascending, so the slice order matches the
    encoded path's row order exactly) and builds the shard-local
    ``MutationBatch`` with O(own rows) gathers: no payload encode, no
    decode, and no O(whole batch) work per shard.
    """

    __slots__ = ("batch", "rows", "n_typed", "n_add")

    def __init__(self, batch: MutationBatch, rows: np.ndarray,
                 n_typed: int, n_add: int):
        self.batch = batch
        self.rows = rows
        self.n_typed = n_typed
        self.n_add = n_add

    def materialize(self) -> MutationBatch:
        b, rows = self.batch, self.rows
        nv, na = self.n_typed, self.n_add
        i1, i2 = np.searchsorted(rows, (nv, nv + na))
        mv = rows[:i1]
        ma = rows[i1:i2] - nv
        md = rows[i2:] - (nv + na)
        return MutationBatch(b.version,
                             add_src=b.add_src[ma], add_dst=b.add_dst[ma],
                             del_src=b.del_src[md], del_dst=b.del_dst[md],
                             add_vertices=b.add_vertices[mv],
                             vertex_types=b.vertex_types[mv])


def stitch_join_views(version: Version, views: list[JoinView], *,
                      device=None) -> JoinView:
    """Merge per-shard canonical CSRs into the global one.

    Every (src, dst) key lives on exactly one shard (plan-based dst
    routing — a migration moves a key wholesale, so this holds across
    splits too) and each shard's rows are already (dst, src)-sorted, so a
    stable argsort of the concatenated keys is a duplicate-safe k-way
    merge: the result is byte-identical to the single store's canonical
    CSR, with its tensors on ``device`` (default: the first shard view's
    device). Raises ``ValueError`` on an empty view list.
    """
    if not views:
        raise ValueError("no shard views to stitch")
    n = views[0].n
    keys = np.concatenate([v.np_keys for v in views])
    src = np.concatenate([v.np_src for v in views])
    dst = np.concatenate([v.np_dst for v in views])
    order = np.argsort(keys, kind="stable")
    in_deg = np.zeros(n, np.int64)
    out_deg = np.zeros(n, np.int64)
    for v in views:
        in_deg += v.np_in_deg
        out_deg += v.np_out_deg
    if device is None:
        device = views[0].src.device
    return build_join_view(version, n, keys[order], src[order], dst[order],
                           in_deg, out_deg, device=device)


@dataclasses.dataclass(frozen=True)
class ReplicaPlan:
    """Seal-coherent replica state for ONE sealed snapshot — the versioned
    sibling of :class:`RoutingPlan` on the read side.

    ``mirrored`` marks the hot vertices whose COMPLETE live out-adjacency
    is mirrored in ``(mirror_src, mirror_dst)`` (canonical (dst, src)
    row order, gathered from the sealed global view — so a mirror row is
    byte-for-byte a row of the snapshot it mirrors). ``src_presence`` is
    the locality index: ``src_presence[j, u]`` is True iff shard ``j``
    holds at least one live out-edge of vertex ``u`` at this snapshot —
    what :func:`replica_route` consults to skip shards that cannot
    contribute to a frontier.

    Coherence is by construction, not by protocol (invariant I10 in
    ``docs/ARCHITECTURE.md``): a plan is built at the publish-at-seal
    boundary from snapshot ``version``'s own views and is only ever
    consulted for windows executing at exactly that version — the
    write-invalidation of the keyed :class:`~repro_torch.core.replica
    .ReplicaManager` protocol falls out for free, because a mutation can
    only land in a LATER sealed snapshot, which gets a fresh plan.
    """
    plan_id: int                # routing plan this was built under
    version: Version            # the one snapshot these mirrors serve
    mirrored: np.ndarray        # (n,) bool — vertex adjacency is mirrored
    mirror_src: np.ndarray      # (mm,) out-edges of mirrored vertices...
    mirror_dst: np.ndarray      # (mm,) ...complete at `version`, canonical
    src_presence: np.ndarray    # (n_shards, n) bool locality index

    @property
    def n_mirrored(self) -> int:
        return int(self.mirrored.sum())


def replica_route(plan: ReplicaPlan, shard_views: list[JoinView],
                  anchors, hops: Optional[int]) -> tuple[
                      np.ndarray, np.ndarray, int, int, int]:
    """Replica-first routing for one same-kind window: compute the union
    frontier closure of ``anchors`` (k-hop sources / reachability sources)
    out to ``hops`` expansions (None = until the frontier drains), pulling
    each hop's neighbors from the MIRROR for mirrored frontier vertices
    and only from shards whose ``src_presence`` says they hold out-edges
    of the non-mirrored rest.

    Returns ``(sub_src, sub_dst, fanout, mirror_hits, mirror_misses)``:
    the restricted edge set (mirror rows + full rows of every shard
    touched), the number of distinct shards touched, and per-vertex
    mirror hit/miss counts. The edge set contains every out-edge of every
    vertex whose edges a ``hops``-step frontier sweep from ``anchors`` can
    read — mirrors are complete per vertex and presence is exact per
    (shard, vertex) — and only rows of the same sealed snapshot, so
    running the ordinary batched kernels on it is byte-identical to
    running them on the stitched global view (the replica-plane
    equivalence tests assert exactly this across split and merge
    cutovers)."""
    n = plan.mirrored.shape[0]
    ids = np.asarray(anchors, np.int64).reshape(-1)
    frontier = np.unique(ids[(ids >= 0) & (ids < n)])
    reached = np.zeros(n, bool)
    reached[frontier] = True
    touched = np.zeros(len(shard_views), bool)
    use_mirror = False
    hits = misses = 0
    fmask = np.empty(n, bool)
    expansions = n if hops is None else int(hops)
    for _ in range(expansions):
        if not frontier.size:
            break
        is_m = plan.mirrored[frontier]
        f_mir, f_rest = frontier[is_m], frontier[~is_m]
        hits += int(f_mir.size)
        misses += int(f_rest.size)
        parts = []
        if f_mir.size:
            use_mirror = True
            fmask[:] = False
            fmask[f_mir] = True
            parts.append(plan.mirror_dst[fmask[plan.mirror_src]])
        if f_rest.size:
            touched |= plan.src_presence[:, f_rest].any(axis=1)
            fmask[:] = False
            fmask[f_rest] = True
            for j in np.flatnonzero(plan.src_presence[:, f_rest]
                                    .any(axis=1)):
                v = shard_views[j]
                parts.append(v.np_dst[fmask[v.np_src]])
        if not parts:
            break
        neigh = np.concatenate(parts).astype(np.int64, copy=False)
        frontier = np.unique(neigh[~reached[neigh]])
        reached[frontier] = True
    src_parts, dst_parts = [], []
    if use_mirror:
        src_parts.append(plan.mirror_src)
        dst_parts.append(plan.mirror_dst)
    for j in np.flatnonzero(touched):
        src_parts.append(shard_views[j].np_src)
        dst_parts.append(shard_views[j].np_dst)
    if src_parts:
        sub_src = np.concatenate(src_parts)
        sub_dst = np.concatenate(dst_parts)
    else:
        sub_src = np.zeros(0, np.int32)
        sub_dst = np.zeros(0, np.int32)
    return sub_src, sub_dst, int(touched.sum()), hits, misses


class ShardedDynamicGraph:
    """N DynamicGraph shards behind an IngestNode + SnapshotCoordinator,
    re-shardable at runtime from observed access patterns.

    Args:
        n_shards: initial shard count (splits may grow it).
        n_max: global vertex capacity (every shard sees the full id space).
        e_max: **per-shard** edge capacity.
        churn_threshold: per-shard delta-view fallback threshold
            (see ``DynamicGraph``).
        route: optional custom routing callable ``key -> shard``
            (NumPy-vectorizable for the batched fast path). Providing one
            disables plan-based routing — and with it re-sharding
            (``split_shard``/``maybe_reshard`` raise / no-op).
        planner: optional :class:`~repro_torch.core.replica.ShardPlanner`
            consulted by :meth:`maybe_reshard`. Without one, re-sharding
            only happens via explicit :meth:`split_shard` calls.
        stats_decay / query_weight: :class:`AccessStats` window shape.
        parallel_apply: size of the persistent thread pool
            :meth:`seal_epoch` dispatches per-shard seals (and therefore
            per-shard ``DynamicGraph.apply`` work) onto. ``0``/``1`` (the
            default) keeps the serial apply plane. Shards share no mutable
            state — each seal touches only its own node, shard store and
            ``shard_apply_seconds`` slot — and the store's batched NumPy
            apply path releases the GIL inside its array kernels, so
            N-shard epochs genuinely overlap. See :meth:`seal_epoch` for
            the failure semantics; call :meth:`shutdown` to reap the pool
            eagerly (it is otherwise reaped with the store).
        device: where every shard keeps its stamp mirrors and join-view
            tensors, and where stitched views live (default ``"cuda"``;
            raises when CUDA is asked for and missing).

    The synchronous driving pattern is one batch per epoch::

        sg.ingest(batch)                  # no-wait dispatch to shards
        sg.seal_epoch(batch.version.epoch)  # seal + apply + advance frontier
        sg.maybe_reshard()                # optional: planner-driven split

    (or ``sg.apply(batch)`` for ingest + seal at once). Per-shard sealing
    (``seal_shard``) lets a straggler shard lag: its slice stays parked and
    the global frontier — and therefore ``join_view`` — holds back until it
    catches up.

    Not internally locked — see the module docstring for the serving
    layer's locking discipline.
    """

    def __init__(self, n_shards: int, n_max: int, e_max: int, *,
                 churn_threshold: float = DEFAULT_CHURN_THRESHOLD,
                 route: Optional[Callable] = None,
                 planner: Optional[ShardPlanner] = None,
                 stats_decay: float = 0.5, query_weight: float = 1.0,
                 parallel_apply: int = 0,
                 wal_dir=None, wal_fsync: str = "batch",
                 wal_fsync_every: int = 32, checkpoint_every: int = 0,
                 checkpoint_keep: int = 2,
                 fault_injector: Optional[FaultInjector] = None,
                 device=DEFAULT_DEVICE):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.device = resolve_device(device)
        self.n_max = n_max
        self.e_max = e_max
        self.churn_threshold = churn_threshold
        self.parallel_apply = int(parallel_apply)
        self._pool = None
        if route is not None:
            if planner is not None:
                raise ValueError(
                    "a custom route disables plan-based re-sharding; "
                    "drop the planner or the route")
            self.plan: Optional[RoutingPlan] = None
            self.route = route
        else:
            self.plan = RoutingPlan.initial(n_shards)
            self.route = self.plan.assign
        self.planner = planner
        self.access_stats = AccessStats(n_shards, decay=stats_decay,
                                        query_weight=query_weight,
                                        n_vertices=n_max)
        self.shards = [self._new_shard() for _ in range(n_shards)]
        self.nodes = [DataNode(i, on_seal=self._on_seal(i))
                      for i in range(n_shards)]
        # nodes is a SHARED list: coordinator and ingest node observe
        # appended shards (splits) without re-wiring
        self.coordinator = SnapshotCoordinator(self.nodes)
        self.ingest_node = IngestNode(self.nodes, route=self.route)
        self.coordinator.subscribe(self.access_stats.on_frontier_advance)
        self._views: dict[int, JoinView] = {}
        self._last_version = -1
        self._ingested_packed: list[int] = []   # every ingested version, asc
        # completed re-sharding records: {"kind", "plan_id", "source",
        # "target", "activation_epoch", "migrated_edges"} — telemetry +
        # plan-aware GC (a merge's source is the retired shard)
        self.migrations: list[dict] = []
        # shards merged away: they stay in ``shards``/``nodes`` (shard ids
        # are positional across the store, and pre-cutover snapshots still
        # resolve from their tombstoned rows) but the plan routes them
        # nothing, so they seal empty epochs from the cutover on
        self.retired: set[int] = set()
        # per-shard cumulative apply seconds — the benchmark's critical-path
        # model of parallel shard ingestion reads these
        self.shard_apply_seconds = [0.0] * n_shards
        # -- durability plane (graph/wal.py) -------------------------------
        self.fault_injector = fault_injector
        self.wal: Optional[GraphWal] = None
        # one append-mode writer per physical shard (None when durability
        # is off or during replay) — shard-owned like ``shards``/``nodes``
        self.wal_shards: list[Optional[ShardWal]] = [None] * n_shards
        self.checkpoint_every = int(checkpoint_every)
        self._ckpt: Optional[GraphCheckpointManager] = None
        self._wal_replaying = False          # replay must not re-append
        self._wal_committed = -1             # newest control-committed epoch
        self._last_ckpt_epoch = -1
        # user-ingested packed versions per not-yet-committed epoch — the
        # control log's commit records carry these so recovery can rebuild
        # latest_sealed() exactly (migration rows are deliberately absent)
        self._epoch_versions: dict[int, list[int]] = {}
        if wal_dir is not None:
            if self.plan is None:
                raise ValueError(
                    "the durable WAL needs plan-based routing (a custom "
                    "route cannot be serialized for recovery)")
            self._attach_wal(
                GraphWal(wal_dir, fsync=wal_fsync,
                         fsync_every=wal_fsync_every),
                checkpoint_keep=checkpoint_keep, fresh=True)

    def _new_shard(self) -> DynamicGraph:
        return DynamicGraph(self.n_max, self.e_max, self.churn_threshold,
                            device=self.device)

    @property
    def n_shards(self) -> int:
        """PHYSICAL shard count (grows by one per split; never shrinks —
        a merge retires a shard in place rather than deleting it, because
        shard ids are positional and old snapshots still resolve from the
        retired shard's rows). Live count is ``len(live_shards())``."""
        return len(self.shards)

    def live_shards(self) -> list[int]:
        """Shard ids the active plan routes keys to (physical minus
        retired), ascending."""
        return [i for i in range(len(self.shards)) if i not in self.retired]

    def _on_seal(self, shard_id: int) -> Callable[[int, list], None]:
        def on_seal(epoch: int, payloads: list) -> None:
            # the chaos hook fires at seal ENTRY — before any apply — so
            # an injected fault aborts the epoch as a clean no-op: it
            # stays pending and re-sealable (I6/I11). Read the seam into
            # a local; replay is fault-free by definition.
            inj = self.fault_injector
            if inj is not None and not self._wal_replaying:
                inj.check(shard_id, epoch)
            t0 = time.perf_counter()
            shard = self.shards[shard_id]
            # payloads arrive in three shapes: whole MutationBatches (the
            # single-shard passthrough), deferred _ShardSlices (the
            # steady-state fast path — materialized HERE, on the parallel
            # apply plane), and encoded row arrays (the straggler/parked
            # and migration paths). Kinds can share an epoch (a slice
            # parked before the shard caught up) but never a version, so
            # merging on the packed version restores apply order.
            direct = []
            arrays = []
            for p in payloads:
                if isinstance(p, _ShardSlice):
                    direct.append(p.materialize())
                elif isinstance(p, MutationBatch):
                    direct.append(p)
                else:
                    arrays.append(p)
            batches = decode_payloads(arrays)
            if direct:
                # encoded rows always precede a same-version direct batch
                # in arrival order (the only same-version pairing is a
                # re-sharding migration slice + the user batch at the
                # cutover version, and the migration dispatches first), so
                # a stable sort + adjacent merge reproduces the encoded
                # path's row order exactly
                batches = _merge_same_version(
                    sorted(batches + direct, key=lambda b: b.version.pack()))
            # pre-check capacity across the WHOLE epoch so a failed seal is
            # a no-op (DynamicGraph.apply is atomic per batch; this makes
            # the seal atomic per epoch) — the epoch stays pending and can
            # be re-sealed after intervention
            adds = sum(len(b.add_src) for b in batches)
            if shard.n_edges + adds > shard.e_max:
                raise MemoryError(
                    f"shard {shard_id}: epoch {epoch} adds {adds} edges to "
                    f"{shard.n_edges}/{shard.e_max}; seal aborted, epoch "
                    "left pending")
            for batch in batches:
                shard.apply(batch)
            # WAL append only after the whole epoch applied: a failed
            # seal leaves no record (the epoch re-seals; a half-applied
            # epoch cannot exist — see the capacity pre-check above).
            # Re-encoding the merged batches reproduces exactly what
            # decode_payloads will regroup on replay, whichever ingest
            # path the rows originally rode. Every seal writes a record —
            # empty epochs included — so the durable frontier's
            # completeness scan is well defined. wal_shards is shard-owned
            # state like ``shards``: only this shard's seal touches its
            # writer.
            w = self.wal_shards[shard_id]
            if w is not None and not self._wal_replaying:
                if not batches:
                    rows = _EMPTY_ROWS
                elif len(batches) == 1:       # steady state: one batch/epoch
                    rows = encode_payload_rows(batches[0])
                else:
                    rows = np.concatenate(
                        [encode_payload_rows(b) for b in batches])
                w.append(epoch, rows)
            self.shard_apply_seconds[shard_id] += time.perf_counter() - t0
        return on_seal

    # -- ingestion ---------------------------------------------------------
    def ingest(self, batch: MutationBatch) -> int:
        """No-wait dispatch of one mutation batch; returns the number of
        mutations dispatched now (the rest park until shards catch up).

        Multiple batches per epoch are fine, but an epoch is closed for
        ingestion once ANY shard has sealed it — a slice delivered to a
        sealed local snapshot could never be applied, so that is an error
        here rather than silent loss.

        Raises:
            ValueError: non-increasing version, already-sealed epoch, or a
                malformed batch (rejected before any version bookkeeping,
                so the corrected batch can retry at the same version).
        """
        v = batch.version.pack()
        if v <= self._last_version:
            raise ValueError("mutation batches must have increasing versions")
        sealed = max(n.local_frontier for n in self.nodes)
        if batch.version.epoch <= sealed:
            raise ValueError(
                f"epoch {batch.version.epoch} is already sealed on some "
                f"shard (max local frontier {sealed}); ingest batches "
                "before sealing their epoch")
        if (self.plan is not None and self.n_shards == 1
                and self.nodes[0].local_frontier >= batch.version.epoch - 1):
            # single-shard passthrough: the plan routes every key to shard
            # 0, so the batch rides to the node AS ITSELF — no payload
            # encode, no routing pass, no decode at seal (the batch is
            # applied as handed in; treat it as immutable once ingested).
            # An ineligible node (straggler restart) falls through to the
            # encoded path, whose parked slices know how to re-dispatch.
            if len(batch.vertex_types) != len(batch.add_vertices):
                # same malformed-batch guard encode_mutations applies,
                # still ahead of any version bookkeeping
                raise ValueError(
                    f"add_vertices ({len(batch.add_vertices)}) and "
                    f"vertex_types ({len(batch.vertex_types)}) disagree "
                    "in length")
            # overflow must raise BEFORE version bookkeeping (like the
            # other two paths) or the epoch wedges pending forever
            pack32_checked(batch.version)
            self._note_ingest(batch.version.epoch, v)
            n = batch.size
            if not n:
                return 0
            self.access_stats.record_mutations(np.asarray([n], np.float64))
            self.nodes[0].receive_batch(
                batch.version.epoch, np.broadcast_to(np.int64(0), (n,)),
                payload=batch)
            self.ingest_node.dispatched += n
            return n
        epoch = batch.version.epoch
        if (self.plan is not None
                and all(n.local_frontier >= epoch - 1 for n in self.nodes)):
            # steady-state fast path (every shard eligible — the no-wait
            # rule can't park anything): one vectorized routing pass over
            # the concatenated keys, then each shard receives a deferred
            # _ShardSlice; the per-shard row gathers happen inside the
            # shards' seals, i.e. on the parallel apply plane, leaving the
            # ingest thread with O(batch) hashing + bincount only.
            # pack32_checked mirrors the encoded path's overflow check
            # (encode first: raise before any version bookkeeping).
            if len(batch.vertex_types) != len(batch.add_vertices):
                raise ValueError(
                    f"add_vertices ({len(batch.add_vertices)}) and "
                    f"vertex_types ({len(batch.vertex_types)}) disagree "
                    "in length")
            pack32_checked(batch.version)
            self._note_ingest(batch.version.epoch, v)
            total = batch.size
            if not total:
                return 0
            n_typed, n_add = len(batch.add_vertices), len(batch.add_src)
            keys = np.concatenate([
                batch.add_vertices, batch.add_dst, batch.del_dst]) \
                .astype(np.int64, copy=False)
            node_ids = self.plan.assign(keys)
            self.access_stats.record_mutations(
                np.bincount(node_ids, minlength=self.n_shards))
            # one stable grouping sort (GIL-releasing); each shard gets its
            # ascending row positions, gathered at ITS seal — O(own rows)
            # per shard, O(batch log batch) here
            order = np.argsort(node_ids, kind="stable")
            sorted_nodes = node_ids[order]
            starts = np.flatnonzero(
                np.r_[True, sorted_nodes[1:] != sorted_nodes[:-1]])
            bounds = np.r_[starts, len(order)]
            for a, b in zip(bounds[:-1], bounds[1:], strict=True):
                self.nodes[int(sorted_nodes[a])].receive_batch(
                    epoch, np.broadcast_to(np.int64(0), (b - a,)),
                    payload=_ShardSlice(batch, order[a:b], n_typed, n_add))
            self.ingest_node.dispatched += total
            return total
        # encode first: if it raises (malformed batch), no version
        # bookkeeping has happened and the same version can be retried —
        # otherwise latest_sealed() could later name a version whose
        # mutations were never applied
        keys, epochs, payload = encode_mutations(batch)
        self._note_ingest(batch.version.epoch, v)
        if not keys.size:
            return 0
        if self.plan is not None:
            # route once here: the node ids both feed the access ledger and
            # override dispatch_batch's routing (same plan, same result)
            node_ids = self.plan.assign(keys)
            self.access_stats.record_mutations(
                np.bincount(node_ids, minlength=self.n_shards))
            return self.ingest_node.dispatch_batch(keys, epochs, payload,
                                                   node_ids=node_ids)
        return self.ingest_node.dispatch_batch(keys, epochs, payload)

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.parallel_apply,
                thread_name_prefix="shard-apply")
        return self._pool

    def shutdown(self) -> None:
        """Reap the parallel-apply thread pool (idempotent; the store
        stays usable — the pool is re-created on the next parallel seal)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def seal_epoch(self, epoch: int) -> int:
        """Seal ``epoch`` on every shard (applying parked + pending slices)
        and advance the global frontier. Returns the new global frontier.

        Seals one epoch per shard per round with a blocked-batch retry
        between rounds: a slice parked because its shard lagged several
        epochs becomes dispatchable the moment the previous epoch seals,
        and must land before its own epoch seals.

        With ``parallel_apply > 1``, each round's per-shard seals — and
        therefore the shards' ``DynamicGraph.apply`` work — run
        concurrently on the persistent thread pool. Shard state is
        disjoint per thread (one node + one store + one telemetry slot
        each); the serial seams (blocked-batch retry between rounds,
        coordinator advance at the end) stay on the calling thread. Every
        shard of a round is awaited even when one fails, then the
        lowest-shard exception is re-raised: exactly like the serial
        plane, a failing shard's epoch stays pending and re-sealable (I6)
        while the global frontier — never advanced here on failure —
        keeps the epoch invisible to queries, so the epoch aborts
        atomically from the store's point of view.
        """
        while any(n.local_frontier < epoch for n in self.nodes):
            self.ingest_node.retry_blocked_batches()
            lagging = [n for n in self.nodes if n.local_frontier < epoch]
            if self.parallel_apply > 1 and len(lagging) > 1:
                futures = [self._executor().submit(
                    n.seal_epoch, n.local_frontier + 1) for n in lagging]
                errors = [f.exception() for f in futures]   # barrier
                for err in errors:
                    if err is not None:
                        raise err
            else:
                for node in lagging:
                    node.seal_epoch(node.local_frontier + 1)
        self.ingest_node.retry_blocked_batches()
        frontier = self.coordinator.advance()
        self._trim_ingest_log()
        return frontier

    def seal_shard(self, shard_id: int, epoch: int) -> int:
        """Seal one shard through ``epoch`` (straggler-paced sealing) and
        advance the global frontier. Returns the new global frontier."""
        node = self.nodes[shard_id]
        while node.local_frontier < epoch:
            self.ingest_node.retry_blocked_batches()
            node.seal_epoch(node.local_frontier + 1)
        self.ingest_node.retry_blocked_batches()
        frontier = self.coordinator.advance()
        self._trim_ingest_log()
        return frontier

    def apply(self, batch: MutationBatch) -> None:
        """Ingest + seal in one step (the DynamicGraph-compatible path)."""
        self.ingest(batch)
        self.seal_epoch(batch.version.epoch)

    # -- durability (graph/wal.py) -----------------------------------------
    def _note_ingest(self, epoch: int, packed: int) -> None:
        """Ingest-path version bookkeeping, shared by all three dispatch
        paths; with a WAL attached, also stages the version for its
        epoch's control-log commit record."""
        self._last_version = packed
        self._ingested_packed.append(packed)
        if self.wal is not None:
            self._epoch_versions.setdefault(epoch, []).append(packed)

    def _attach_wal(self, wal: GraphWal, *, checkpoint_keep: int,
                    fresh: bool) -> None:
        """Wire a WAL into the store: per-shard writers, the checkpoint
        manager, and the frontier subscription that writes commit
        records. ``fresh`` stores the construction parameters in the
        control log (recovery rebuilds the store from them); a recovered
        store reattaches with ``fresh=False``."""
        self.wal = wal
        if fresh:
            wal.write_meta({
                "n_base": self.plan.n_base, "n_max": self.n_max,
                "e_max": self.e_max,
                "churn_threshold": self.churn_threshold,
                "parallel_apply": self.parallel_apply,
                "fsync": wal.fsync, "fsync_every": wal.fsync_every,
                "checkpoint_every": self.checkpoint_every,
                "checkpoint_keep": int(checkpoint_keep)})
        self.wal_shards = [wal.shard_wal(i)
                          for i in range(len(self.shards))]
        self._ckpt = GraphCheckpointManager(wal.dir / "checkpoints",
                                            keep=checkpoint_keep)
        self.coordinator.subscribe(self._wal_on_frontier)

    def _wal_on_frontier(self, frontier: int) -> None:
        """Frontier subscriber: one control-log commit record per
        newly-sealed epoch (carrying its staged user-ingested versions),
        then a periodic checkpoint. Runs on the serial thread inside
        ``coordinator.advance`` — the shard records for these epochs were
        appended by the very seals that enabled the advance."""
        if self.wal is None or self._wal_replaying:
            return
        for e in range(self._wal_committed + 1, frontier + 1):
            self.wal.commit_epoch(e, self._epoch_versions.pop(e, []))
        self._wal_committed = frontier
        if (self.checkpoint_every > 0
                and frontier - self._last_ckpt_epoch
                >= self.checkpoint_every):
            self.checkpoint()

    def checkpoint(self) -> Optional[int]:
        """Durable snapshot of the whole store at the current global
        frontier; every shard's WAL rotates to a fresh segment and the
        segments the checkpoint covers are dropped. Returns the
        checkpointed epoch, or None when no consistent cut exists right
        now (nothing sealed yet, or a straggler-paced shard's local
        frontier is ahead of the global one — its post-frontier applies
        are not part of any globally-sealed snapshot).

        Raises ``ValueError`` without a WAL directory (the checkpoint
        ladder is part of the durability plane, not a standalone
        feature)."""
        if self._ckpt is None:
            raise ValueError("checkpointing needs a WAL directory "
                             "(construct with wal_dir=...)")
        f = self.coordinator.global_frontier
        if f < 0 or any(n.local_frontier != f for n in self.nodes):
            return None
        self._ckpt.save_graph(self, epoch=f)
        for w in self.wal_shards:
            if w is not None:
                w.rotate(f + 1)
                w.drop_segments_below(f + 1)
        self.wal.sync()
        self._last_ckpt_epoch = f
        return f

    def _replay_plan_event(self, ev: dict) -> None:
        """Re-execute one re-sharding cutover structurally during WAL
        replay: plan swap, shard allocation/retirement, ledger reset and
        telemetry — everything :meth:`split_shard`/:meth:`merge_shards`
        does EXCEPT dispatching migration rows, which already ride the
        shard WAL records of the activation epoch."""
        op, a, b = ev["op"], ev["a"], ev["b"]
        activation = ev["activation"]
        if op == "split":
            new_plan = self.plan.split(a, activation)
            target = new_plan.leaves[-1].shard
            if target != b or target != len(self.shards):
                raise ValueError(
                    f"plan replay allocated shard {target} but the "
                    f"control log names {b} with {len(self.shards)} "
                    "physical shards — control log and checkpoint "
                    "disagree")
            self.shards.append(self._new_shard())
            node = DataNode(target, on_seal=self._on_seal(target))
            node.local_frontier = activation - 1
            self.nodes.append(node)
            self.shard_apply_seconds.append(0.0)
            self.wal_shards.append(None)   # writers attach after replay
            src, tgt = a, b
        elif op == "merge":
            if self.plan.sibling_of(b) != a:
                raise ValueError(
                    f"control log merges shard {b} into {a} but its "
                    f"sibling under the replayed plan is "
                    f"{self.plan.sibling_of(b)}")
            new_plan = self.plan.merge(b, activation)
            self.retired.add(b)
            src, tgt = b, a
        else:
            raise ValueError(f"unknown plan event op {op!r}")
        self.plan = new_plan
        self.route = new_plan.assign
        self.ingest_node.route = new_plan.assign
        self.access_stats.reset(self.n_shards)
        self.migrations.append({
            "kind": op, "plan_id": new_plan.plan_id,
            "source": src, "target": tgt,
            "activation_epoch": activation,
            "migrated_edges": int(ev.get("migrated", 0))})

    def _restore_checkpoint(self, snap: dict) -> None:
        """Load a :meth:`GraphCheckpointManager.load_graph` snapshot into
        a freshly-constructed store: plan history, per-shard arrays (with
        live-index rebuild), access ledger, ingest log."""
        meta = snap["meta"]
        epoch = snap["epoch"]
        history = tuple(tuple(ev) for ev in meta["plan_history"])
        plan = RoutingPlan.replay(self.plan.n_base, history)
        for i in range(len(self.shards), plan.n_total):
            self.shards.append(self._new_shard())
            self.nodes.append(DataNode(i, on_seal=self._on_seal(i)))
            self.shard_apply_seconds.append(0.0)
            self.wal_shards.append(None)
        self.plan = plan
        self.route = plan.assign
        self.ingest_node.route = plan.assign
        self.retired = set(meta["retired"])
        self.migrations = list(meta["migrations"])
        for shard, arrays in zip(self.shards, snap["shards"],
                                 strict=True):
            k = len(arrays["src"])
            shard.src[:k] = arrays["src"]
            shard.dst[:k] = arrays["dst"]
            shard.created[:k] = arrays["created"]
            shard.deleted[:k] = arrays["deleted"]
            shard.n_edges = k
            shard.v_created[:] = arrays["v_created"]
            shard.v_type[:] = arrays["v_type"]
            shard.n_vertices = int((shard.v_created != MAXV).sum())
            last = int(arrays["last_version"])
            shard.versions = [Version.unpack(last)] if last >= 0 else []
            shard._log_floor = last
            shard._rebuild_index()
            shard.sync_stamp_mirrors()
        for node in self.nodes:
            node.local_frontier = epoch
        # -> checkpoint epoch; ticks the ledger decay once, which the
        # restore below overwrites wholesale
        self.coordinator.advance()
        stats = meta["stats"]
        self.access_stats.reset(len(self.shards))
        self.access_stats.mutations[:] = stats["mutations"]
        self.access_stats.queries[:] = stats["queries"]
        self.access_stats.epochs_observed = stats["epochs_observed"]
        self.access_stats.vertex_heat[:] = snap["vertex_heat"]
        self._last_version = int(meta["last_version"])
        self._ingested_packed = [int(v) for v in meta["ingested_packed"]]
        self._last_ckpt_epoch = epoch

    @classmethod
    def recover(cls, wal_dir, *, planner: Optional[ShardPlanner] = None,
                parallel_apply: Optional[int] = None,
                fault_injector: Optional[FaultInjector] = None,
                checkpoint_every: Optional[int] = None,
                wal_fsync: Optional[str] = None,
                wal_fsync_every: Optional[int] = None,
                device=DEFAULT_DEVICE) -> "ShardedDynamicGraph":
        """Rebuild a store from its durability directory: the latest
        graph checkpoint plus the WAL tail, replayed through the ordinary
        receive/seal machinery — so the recovered store is byte-identical
        to the uncrashed oracle at every sealed epoch up to the durable
        frontier, across split and merge cutovers included (the control
        log replays the plan history; migration rows ride the shard
        records of their activation epoch like any other payload).

        The durable frontier is the newest epoch ``e`` such that every
        epoch through ``e`` has a control-log commit record AND an intact
        record on every shard required at it (batched fsync may lose an
        unsynced suffix of either — the minimum rule means that only
        shortens recovery, never corrupts it). Records beyond the durable
        frontier — committed-but-incomplete epochs, uncommitted plan
        events, torn tails — are truncated away so the caller re-ingests
        those epochs cleanly.

        Keyword overrides replace the persisted construction parameters
        (planner/fault_injector are process-local objects and never
        persist). Raises ``ValueError`` when the directory holds no WAL
        meta record; :class:`WalCorruptionError` on mid-segment
        corruption. The recovered store lives on ``device``."""
        wal_dir = pathlib.Path(wal_dir)
        meta, events, commits = GraphWal.read_control(wal_dir)
        if meta is None:
            raise ValueError(
                f"no WAL meta record under {wal_dir}; nothing to recover")
        ckpt_keep = int(meta.get("checkpoint_keep", 2))
        ckpt = GraphCheckpointManager(wal_dir / "checkpoints",
                                      keep=ckpt_keep)
        snap = ckpt.load_graph()
        store = cls(
            int(meta["n_base"]), int(meta["n_max"]), int(meta["e_max"]),
            churn_threshold=meta["churn_threshold"],
            planner=planner,
            parallel_apply=(int(meta.get("parallel_apply", 0))
                            if parallel_apply is None else parallel_apply),
            device=device)
        store._wal_replaying = True
        c = -1
        if snap is not None:
            store._restore_checkpoint(snap)
            c = snap["epoch"]
        # cutovers not yet folded into the checkpoint's plan history (the
        # control log's plan events and the history grow in lockstep)
        tail_events = events[len(store.plan.history):]
        shard_records: dict[int, dict] = {}
        for d in sorted(wal_dir.glob("shard-*")):
            sid = int(d.name.split("-", 1)[1])
            shard_records[sid] = scan_shard_records(d)

        def shards_required(epoch: int) -> int:
            n = int(meta["n_base"])
            for ev in events:
                if ev["op"] == "split" and ev["activation"] <= epoch:
                    n += 1
            return n

        durable = c
        e = c + 1
        while e in commits and all(
                e in shard_records.get(sid, {})
                for sid in range(shards_required(e))):
            durable = e
            e += 1
        by_activation: dict[int, list[dict]] = {}
        for ev in tail_events:
            if ev["activation"] <= durable:
                by_activation.setdefault(ev["activation"], []).append(ev)
        for e in range(c + 1, durable + 1):
            for ev in by_activation.get(e, ()):
                store._replay_plan_event(ev)
            for sid in range(len(store.nodes)):
                rows = shard_records.get(sid, {}).get(e)
                node = store.nodes[sid]
                if rows is not None and len(rows[0]):
                    node.receive_batch(
                        e, np.broadcast_to(np.int64(0), (len(rows[0]),)),
                        payload=rows[0])
                node.seal_epoch(e)
            store.coordinator.advance()
        # ingest-log bookkeeping for the replayed tail, straight from the
        # commit records (checkpoint meta covered epochs <= c)
        packed_tail = [v for e2 in range(c + 1, durable + 1)
                       for v in commits.get(e2, [])]
        if packed_tail:
            store._ingested_packed.extend(packed_tail)
            store._last_version = packed_tail[-1]
        store._trim_ingest_log()
        store._wal_replaying = False
        # drop everything beyond the durable frontier BEFORE reattaching
        # append-mode writers: complete-but-uncommitted records (their
        # epochs get re-ingested and re-appended), uncommitted plan
        # events, and torn tails (a writer must reopen on a record
        # boundary)
        for d in wal_dir.glob("shard-*"):
            truncate_shard_after(d, durable)
        GraphWal.truncate_control_after(wal_dir, durable)
        store.checkpoint_every = (int(meta.get("checkpoint_every", 0))
                                  if checkpoint_every is None
                                  else int(checkpoint_every))
        store._attach_wal(
            GraphWal(wal_dir,
                     fsync=(meta.get("fsync", "batch")
                            if wal_fsync is None else wal_fsync),
                     fsync_every=(int(meta.get("fsync_every", 32))
                                  if wal_fsync_every is None
                                  else int(wal_fsync_every))),
            checkpoint_keep=ckpt_keep, fresh=False)
        store._wal_committed = durable
        store.fault_injector = fault_injector
        return store

    # -- re-sharding -------------------------------------------------------
    def record_query_touches(self, vertex_ids) -> None:
        """Feed query access patterns into the ledger: ``vertex_ids`` are
        the vertices a query window touched (sources/targets); they are
        binned to shards under the active plan. No-op under a custom
        route. Called by the serving layer inside its lock."""
        if self.plan is None:
            return
        ids = np.asarray(vertex_ids, np.int64)
        if not ids.size:
            return
        self.access_stats.record_queries(
            np.bincount(self.plan.assign(ids), minlength=self.n_shards))
        # per-vertex heat feeds hot-vertex mirror nomination (replica
        # plane); deliberately NOT fed from the ingest hot path — query
        # skew, not write skew, is what mirrors exploit
        self.access_stats.record_vertex_touches(ids)

    def is_quiescent(self) -> bool:
        """True when nothing is in flight: every local frontier equals the
        global frontier, the last ingested epoch is sealed, and no slice
        is parked OR pending on any node. This is the re-sharding cutover
        precondition — it guarantees every mutation of epochs < activation
        has been applied under the retiring plan, so swapping the route
        never re-routes an in-flight pre-cutover slice. (The pending-map
        check matters for back-to-back splits: a prior split's migration
        slices sit pending until their activation epoch seals, and a
        second split reading the source shard before then would
        re-migrate rows the first move already claimed.)"""
        f = self.coordinator.global_frontier
        return (not self.ingest_node.blocked
                and not self.ingest_node.blocked_batches
                and all(n.local_frontier == f for n in self.nodes)
                and Version.unpack(self._last_version).epoch <= f
                and not any(n.pending or n.pending_batches
                            or n.pending_payloads for n in self.nodes))

    def split_shard(self, hot_shard: int) -> dict:
        """Split ``hot_shard``'s key range: activate the successor plan at
        the next epoch and migrate the moving half-range.

        The migration rides as ordinary mutation payloads: for each live
        row whose key moves, a delete dispatched to the source shard and an
        add (in original creation order, preserving LIFO delete semantics)
        to the new shard, all at version ``(activation_epoch, 0)``. Both
        slices apply atomically when the activation epoch seals, so no
        query — always answered at a frontier-sealed snapshot — can
        observe a half-migrated graph. User batches may share the cutover
        version; ``decode_payloads`` merges them in arrival order.

        Returns a summary dict (plan id, source/target shards, activation
        epoch, migrated edge count), also appended to :attr:`migrations`.

        Raises:
            ValueError: custom-route store (no plan to split).
            RuntimeError: store not quiescent (see :meth:`is_quiescent`).
        """
        if self.plan is None:
            raise ValueError("re-sharding needs plan-based routing "
                             "(construct without a custom `route`)")
        if not self.is_quiescent():
            raise RuntimeError(
                "re-sharding requires a quiescent store: seal every "
                "ingested epoch on every shard first")
        if hot_shard in self.retired:
            raise ValueError(f"shard {hot_shard} is retired (merged away)")
        activation = self.coordinator.global_frontier + 1
        new_plan = self.plan.split(hot_shard, activation)
        # the new leaf's shard id, allocated from the plan's monotone
        # physical counter — NOT n_shards-1, which under-counts once a
        # merge has retired a leaf
        target = new_plan.leaves[-1].shard
        if target != len(self.shards):   # pragma: no cover - plan invariant
            raise AssertionError(
                f"plan allocated shard {target}, store has "
                f"{len(self.shards)} physical shards")
        shard = self._new_shard()
        node = DataNode(target, on_seal=self._on_seal(target))
        # the new shard joins AT the cutover boundary: marking every prior
        # epoch locally sealed is sound because the plan routed it nothing
        # before activation
        node.local_frontier = activation - 1
        self.shards.append(shard)
        self.nodes.append(node)      # shared list: coordinator+ingest see it
        self.shard_apply_seconds.append(0.0)
        self.wal_shards.append(
            self.wal.shard_wal(target) if self.wal is not None else None)
        migrated = self._dispatch_migration(hot_shard, target, new_plan,
                                            activation)
        self.plan = new_plan
        self.route = new_plan.assign
        self.ingest_node.route = new_plan.assign
        self.access_stats.reset(self.n_shards)
        summary = {"kind": "split", "plan_id": new_plan.plan_id,
                   "source": hot_shard, "target": target,
                   "activation_epoch": activation,
                   "migrated_edges": migrated}
        self.migrations.append(summary)
        if self.wal is not None:
            self.wal.record_plan_event("split", hot_shard, target,
                                       activation, migrated)
        return summary

    def merge_shards(self, removed_shard: int) -> dict:
        """Coarsen a split back: fold ``removed_shard``'s half-range into
        its split sibling (the leaf differing only in the newest path
        bit), the inverse of :meth:`split_shard`.

        Same cutover discipline as a split — quiescent store, successor
        plan activating at the next epoch, the retiring shard's live rows
        riding the ordinary ingest path as (delete @ source, add @
        survivor) payload rows at version ``(activation, 0)``, applied
        atomically when that epoch seals. Under the merged plan EVERY
        live key of the removed leaf routes to the survivor, so the
        migration drains the shard completely; it is then retired in
        place (see :attr:`retired`) — pre-cutover snapshots keep
        resolving from its tombstoned rows, post-cutover it seals empty
        epochs. Views are byte-identical across the cutover at every
        sealed version (the merge-coherence tests assert this).

        Returns a summary dict (also appended to :attr:`migrations`).

        Raises:
            ValueError: custom-route store, retired/unknown shard, or a
                shard whose leaf has no split sibling (depth-0 base
                leaves never merge).
            RuntimeError: store not quiescent.
        """
        if self.plan is None:
            raise ValueError("re-sharding needs plan-based routing "
                             "(construct without a custom `route`)")
        if removed_shard in self.retired:
            raise ValueError(f"shard {removed_shard} is already retired")
        if not self.is_quiescent():
            raise RuntimeError(
                "re-sharding requires a quiescent store: seal every "
                "ingested epoch on every shard first")
        survivor = self.plan.sibling_of(removed_shard)
        if survivor is None:
            raise ValueError(
                f"shard {removed_shard} has no split sibling to merge "
                "into (only split halves can coarsen back)")
        activation = self.coordinator.global_frontier + 1
        new_plan = self.plan.merge(removed_shard, activation)
        migrated = self._dispatch_migration(removed_shard, survivor,
                                            new_plan, activation)
        self.plan = new_plan
        self.route = new_plan.assign
        self.ingest_node.route = new_plan.assign
        self.retired.add(removed_shard)
        self.access_stats.reset(self.n_shards)
        summary = {"kind": "merge", "plan_id": new_plan.plan_id,
                   "source": removed_shard, "target": survivor,
                   "activation_epoch": activation,
                   "migrated_edges": migrated}
        self.migrations.append(summary)
        if self.wal is not None:
            # history-tuple order: (survivor, removed)
            self.wal.record_plan_event("merge", survivor, removed_shard,
                                       activation, migrated)
        return summary

    def _dispatch_migration(self, source: int, target: int,
                            new_plan: RoutingPlan, epoch: int) -> int:
        """Dispatch the moving half-range as payload rows at the cutover
        version. Quiescence makes 'live now' == 'live at the cutover
        snapshot', and makes both dispatch targets eligible (no parking)."""
        shard = self.shards[source]
        e = shard.n_edges
        live = np.flatnonzero(shard.deleted[:e] == MAXV)
        if not live.size:
            return 0
        route_keys = shard.dst[live].astype(np.int64)
        rows = live[new_plan.assign(route_keys) != source]
        n = rows.size
        if not n:
            return 0
        v = pack32_checked(Version(epoch, 0))
        payload = np.empty((2 * n, 4), np.int32)
        payload[:, 3] = v
        payload[:n, 0] = K_DEL            # source loses the moving rows...
        payload[n:, 0] = K_ADD            # ...target gains them, same order
        payload[:n, 1] = payload[n:, 1] = shard.src[rows]
        payload[:n, 2] = payload[n:, 2] = shard.dst[rows]
        keys = np.concatenate([shard.dst[rows], shard.dst[rows]]) \
            .astype(np.int64)
        node_ids = np.concatenate([np.full(n, source, np.int64),
                                   np.full(n, target, np.int64)])
        sent = self.ingest_node.dispatch_batch(
            keys, np.full(2 * n, epoch, np.int64), payload,
            node_ids=node_ids)
        if sent != 2 * n:                  # pragma: no cover - guarded above
            raise AssertionError("migration slice parked despite quiescence")
        return n

    def maybe_reshard(self) -> Optional[dict]:
        """Planner tick: consult the :class:`ShardPlanner` on the current
        access ledger and execute the proposed split — or, failing that,
        the proposed cold-sibling merge — if any.

        Safe to call every epoch — returns None (without touching the
        store) when there is no planner, the store is not quiescent, or
        the planner declines both ways. Returns the
        :meth:`split_shard` / :meth:`merge_shards` summary with the
        planner's ``reason`` attached. Retired shards are masked out of
        both decisions (their permanently-zero loads would deflate the
        mean every live shard is compared against)."""
        if self.planner is None or self.plan is None:
            return None
        if not self.is_quiescent():
            return None
        loads = self.access_stats.loads()
        live = np.ones(self.n_shards, bool)
        if self.retired:
            live[list(self.retired)] = False
        decision = self.planner.propose(
            loads, epochs_observed=self.access_stats.epochs_observed,
            live=live)
        if decision is not None:
            summary = self.split_shard(decision.shard)
            summary["reason"] = decision.reason
            return summary
        merge = self.planner.propose_merge(
            loads, epochs_observed=self.access_stats.epochs_observed,
            pairs=self.plan.mergeable_pairs(), live=live)
        if merge is None:
            return None
        summary = self.merge_shards(merge.removed)
        summary["reason"] = merge.reason
        return summary

    def plan_floor(self) -> int:
        """Packed version below which cached artifacts (stitched views,
        per-shard views, PageRank ranks) were built under a retired
        routing plan: ``(activation_epoch, 0)`` of the active plan, or 0
        if no split has happened (nothing is retired). The GC ladders use
        this to drop retired-plan entries outright instead of aging them
        out."""
        if self.plan is None or self.plan.plan_id == 0:
            return 0
        return Version(self.plan.activation_epoch, 0).pack()

    # -- snapshots ---------------------------------------------------------
    def latest_sealed(self) -> Optional[Version]:
        """Newest frontier-sealed snapshot version — the only snapshot an
        online query may be answered against (never a partially-sealed
        epoch). Returns the newest ingested version whose epoch every shard
        has sealed; ``Version(frontier, 0)`` if the sealed epochs carried no
        batches (a sealed empty snapshot is queryable); ``None`` before the
        first global seal. (A re-sharding migration is not an ingested
        version: it changes row placement, never snapshot content.)

        Pure read: no writes, so the serving tier's read plane may call it
        without the write lock. The ingest-log trim that used to piggyback
        on this lookup runs at seal time (:meth:`_trim_ingest_log`)."""
        frontier = self.coordinator.global_frontier
        if frontier < 0:
            return None
        log = self._ingested_packed
        for i in range(len(log) - 1, -1, -1):
            v = Version.unpack(log[i])
            if v.epoch <= frontier:
                return v
        return Version(frontier, 0)

    def _trim_ingest_log(self) -> None:
        """Drop ingest-log entries older than the newest sealed one. The
        frontier is monotone, so those entries can never be
        ``latest_sealed()``'s answer again — trimming at every seal keeps
        the log bounded by the unsealed backlog, not the stream length.
        Runs on the write plane (seal paths) only, which is what lets
        :meth:`latest_sealed` itself be a pure lock-free read."""
        frontier = self.coordinator.global_frontier
        log = self._ingested_packed
        for i in range(len(log) - 1, -1, -1):
            if Version.unpack(log[i]).epoch <= frontier:
                if i > 0:
                    del log[:i]
                return

    def on_frontier_advance(self, fn: Callable[[int], None]) -> None:
        """Subscribe ``fn(new_frontier)`` to global-seal notifications —
        fires whenever an epoch becomes sealed on every shard (i.e. a newer
        consistent snapshot became queryable)."""
        self.coordinator.subscribe(fn)

    def _gate(self, version: Version) -> None:
        if version.epoch > self.coordinator.global_frontier:
            raise ValueError(
                f"epoch {version.epoch} is not globally sealed (frontier "
                f"{self.coordinator.global_frontier}); snapshots become "
                "queryable once every shard seals them")

    def shard_views(self, version: Version,
                    use_kernel: Optional[bool] = None) -> list[JoinView]:
        """Per-shard join views for a sealed snapshot — pre-sharded input
        for ``partition.partition_graph_sharded`` (no re-bucketing).
        Raises ``ValueError`` if ``version`` is not globally sealed."""
        self._gate(version)
        return [s.join_view(version, use_kernel=use_kernel)
                for s in self.shards]

    def join_view(self, version: Version,
                  use_kernel: Optional[bool] = None) -> JoinView:
        """The stitched global CSR for a sealed snapshot (cached).
        Byte-identical to the single store's view at the same version —
        including versions older than a re-sharding cutover, which resolve
        from the pre-migration rows. Raises ``ValueError`` if ``version``
        is not globally sealed."""
        key = version.pack()
        if key in self._views:
            return self._views[key]
        view = stitch_join_views(version,
                                 self.shard_views(version,
                                                  use_kernel=use_kernel),
                                 device=self.device)
        self._views[key] = view
        return view

    def build_replica_plan(self, version: Version, hot_ids,
                           use_kernel: Optional[bool] = None) -> ReplicaPlan:
        """Materialize the replica plane for one sealed snapshot: mirror
        the complete live out-adjacency of ``hot_ids`` (gathered from the
        stitched global view, so mirror rows are byte-for-byte snapshot
        rows in canonical order) and build the per-shard ``src_presence``
        locality index from the per-shard views.

        Called by the serving layer at the publish-at-seal boundary —
        rebuilding from ``version``'s own views at every publish IS the
        coherence protocol (invariant I10): a mirror can never be staler
        than the snapshot it is consulted for, because it is derived from
        it. Raises ``ValueError`` if ``version`` is not globally sealed."""
        self._gate(version)
        views = self.shard_views(version, use_kernel=use_kernel)
        n = self.n_max
        mirrored = np.zeros(n, bool)
        ids = np.asarray(hot_ids, np.int64).reshape(-1)
        mirrored[ids[(ids >= 0) & (ids < n)]] = True
        g = self.join_view(version, use_kernel=use_kernel)
        sel = mirrored[g.np_src]
        presence = np.zeros((len(views), n), bool)
        for j, v in enumerate(views):
            presence[j, v.np_src] = True
        pid = self.plan.plan_id if self.plan is not None else -1
        return ReplicaPlan(pid, version, mirrored,
                           g.np_src[sel], g.np_dst[sel], presence)

    def gc_views(self, keep_latest: int = 4) -> int:
        """Ladder-GC every shard's view cache plus the stitched cache,
        and drop entries keyed by retired routing plans.

        After a split, retired entries are dropped instead of aging
        through the ladder: the stitched cache drops everything below the
        active plan's activation (:meth:`plan_floor`), and each shard
        involved in a migration drops its views from before *its own* most
        recent migration (those still carry — or are missing — the moved
        rows; views from between someone else's later split and now are
        untouched, so an old split never wipes another shard's warm
        ladder). In both cases entries only drop once a post-cutover
        entry exists, so the serving snapshot is never evicted from under
        the server. Returns the number dropped."""
        dropped = prune_retired(self._views, self.plan_floor())
        shard_floor: dict[int, int] = {}
        for m in self.migrations:
            fl = Version(m["activation_epoch"], 0).pack()
            for i in (m["source"], m["target"]):
                shard_floor[i] = max(shard_floor.get(i, 0), fl)
        dropped += sum(
            s.gc_views(keep_latest, retire_below=shard_floor.get(i, 0))
            for i, s in enumerate(self.shards))
        return dropped + prune_views(self._views, keep_latest)

    # -- merged vertex/edge state -----------------------------------------
    @property
    def n_edges(self) -> int:
        """Edge rows appended across all shards — the capacity measure,
        not the live-edge count. A re-sharding migration re-appends the
        moving rows on the target shard (and tombstones them on the
        source), so after a split this exceeds the single store's row
        count even though every snapshot's live edges are identical."""
        return sum(s.n_edges for s in self.shards)

    @property
    def v_created(self) -> np.ndarray:
        """Global creation stamps: a vertex exists from the earliest version
        any shard created it (explicit add on its home shard, or endpoint
        auto-creation wherever its edges landed)."""
        out = self.shards[0].v_created.copy()
        for s in self.shards[1:]:
            np.minimum(out, s.v_created, out=out)
        return out

    @property
    def v_type(self) -> np.ndarray:
        """Global vertex types, matching the single store's
        first-creation-wins semantics: the type recorded by whichever
        shard(s) created the vertex at its earliest creation version.

        At that version at most one shard received the *typed* add (routing
        sends a vertex id to exactly one shard per plan); any other shard
        tied at the same version auto-created the vertex untyped (0), so
        the elementwise max over tied shards recovers the typed value —
        with no dependence on the CURRENT route, which re-sharding may
        have changed since the vertex was created."""
        created = self.v_created
        out = np.zeros(self.n_max, np.int32)
        for s in self.shards:
            mine = s.v_created == created
            np.maximum(out, np.where(mine, s.v_type, 0), out=out)
        return out

    @property
    def n_vertices(self) -> int:
        """Vertices created on any shard so far."""
        return int((self.v_created != MAXV).sum())

    def num_vertices(self, version: Optional[Version] = None) -> int:
        """Vertices existing at ``version`` (or now, when None)."""
        if version is None:
            return self.n_vertices
        return int((self.v_created <= pack32_clamped(version)).sum())

    @property
    def view_delta_patches(self) -> int:
        return sum(s.view_delta_patches for s in self.shards)

    @property
    def view_full_builds(self) -> int:
        return sum(s.view_full_builds for s in self.shards)

    def shard_edge_counts(self) -> list[int]:
        """Per-shard live-edge counts (the placement the plan produced)."""
        return [s.n_edges for s in self.shards]
