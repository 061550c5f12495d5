"""Online graph-query layer: typed queries, window batching, per-snapshot
result caching.

The paper's online half answers low-latency queries against the newest
*consistent* snapshot while mutations stream. This module is the snapshot-
local piece: a :class:`SnapshotQueryEngine` takes a window of typed queries
(:class:`KHop`, :class:`Reachability`, :class:`DegreeTopK`,
:class:`PageRankQuery`) and answers the whole window with as few vectorized
calls as possible —

* all k-hop queries with the same ``k`` become ONE ``batched_k_hop`` sweep,
* all reachability queries become ONE multi-source ``batched_reachability``
  frontier,
* degree top-k queries group by (k, direction),
* PageRank is computed at most once per snapshot version: results are
  cached per packed version and **warm-started** from the nearest older
  cached ranks via ``incremental_pagerank`` (the paper's "adapt to the
  changes first" rule), so an epoch's ranks converge in a fraction of the
  cold-start iterations. The cache is GC'd with the same version-spaced
  ``ladder_keep`` retention the view caches use, so serving memory stays
  bounded under churn.

The serving fast path adds a **versioned result cache** on top: every
answered query is memoized under ``(packed version, kind,
canonical-args fingerprint)`` — see :func:`query_fingerprint` — so a
repeated query at the same sealed snapshot is a dict lookup, not a kernel
call. Invalidation is by construction, not by protocol: a mutation can
only land in a LATER sealed version, which is a brand-new key space, so
no entry can ever go stale (the same argument as the replica plane's I10
coherence). A pinned replay keys into its own pinned version's space and
therefore can never observe another version's cache. The outer
per-version dict is GC'd by the same ladder the rank cache uses; the
inner per-version dict is capped (``result_cache_entries``). The engine
also records the shape *signatures* windows actually hit (kind,
static args, pow2-padded source width) so :meth:`SnapshotQueryEngine
.warm_traces` — the publish-time prewarm — can retrace exactly the
shapes real clients use against a new snapshot's edge bucket.

The engine is deliberately snapshot-agnostic — the serving loop
(``launch.serve_graph``) picks WHICH snapshot (always
``ShardedDynamicGraph.latest_sealed()``) and hands the view in. It is
layer 4 of the pipeline mapped in ``docs/ARCHITECTURE.md``; the
:func:`query_touch_vertices` helper is the access-pattern feed for the
re-sharding planner described there.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.versioned import Version
from repro_torch.device import to_host
from repro_torch.graph import compute as gc
from repro_torch.graph.dyngraph import JoinView, prune_retired, prune_views
from repro_torch.graph.sharded import ReplicaPlan, replica_route


# ------------------------------------------------------------- query types
@dataclasses.dataclass(frozen=True)
class KHop:
    """Vertices within ``k`` out-hops of ``source`` -> (n,) bool mask."""
    source: int
    k: int


@dataclasses.dataclass(frozen=True)
class Reachability:
    """Is ``dst`` reachable from ``src``? -> bool."""
    src: int
    dst: int
    max_hops: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DegreeTopK:
    """Top-k vertices by degree -> (ids, degrees) arrays."""
    k: int
    direction: str = "in"


@dataclasses.dataclass(frozen=True)
class PageRankQuery:
    """PageRank ranks -> (n,) array, or (ids, ranks) when ``top_k`` set."""
    top_k: Optional[int] = None


Query = Union[KHop, Reachability, DegreeTopK, PageRankQuery]

_KIND_OF = {KHop: "k_hop", Reachability: "reachability",
            DegreeTopK: "degree_topk", PageRankQuery: "pagerank"}


def query_kind(q) -> Optional[str]:
    """Stable kind tag for a query (``"k_hop"`` / ``"reachability"`` /
    ``"degree_topk"`` / ``"pagerank"``), or None for an object that is not
    a known query type — the admission-time validity check the typed
    request path uses instead of letting an unknown type poison a whole
    execution window."""
    return _KIND_OF.get(type(q))


# ------------------------------------------------- typed request envelope
#
# One envelope shared VERBATIM by the in-process scheduler
# (``launch.serve_graph.GraphQueryServer.submit_request``) and the wire
# path (``launch.rpc`` encodes/decodes exactly these dataclasses): a
# request names its query, an id the caller correlates the answer by, an
# optional snapshot pin and an optional latency budget; a response is
# either an answer (value + the sealed version it was computed at) or a
# typed error. The legacy ``submit()``/``flush()`` surface is a thin shim
# over this envelope.

# error codes a response can carry (stable wire names)
ERR_OVERLOADED = "overloaded"     # admission control shed the request
ERR_DEADLINE = "deadline"         # latency budget expired before execution
ERR_UNSEALED = "unsealed"         # no globally sealed snapshot yet
ERR_BAD_PIN = "bad_pin"           # pinned version not sealed / not served
ERR_BAD_QUERY = "bad_query"       # unknown query kind / malformed fields


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One typed query submission.

    ``request_id`` is the caller's correlation token (unique per
    connection on the wire path; auto-assigned on the in-process
    conveniences). ``pin_version`` pins execution to a specific *sealed*
    snapshot instead of the newest one — a pinned replay is how the soak
    tests prove byte-identity, and how a training run stays reproducible.
    ``deadline_s`` is a relative latency budget from submission: a request
    still queued when it expires is answered with an ``ERR_DEADLINE``
    error instead of stale data."""
    query: Query
    request_id: Union[int, str] = 0
    pin_version: Optional[Version] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class QueryError:
    """Typed failure surface of a :class:`QueryResponse` (never an
    exception string a client has to parse): ``code`` is one of the
    ``ERR_*`` constants, ``message`` is human-readable detail."""
    code: str
    message: str = ""


@dataclasses.dataclass(frozen=True)
class QueryResponse:
    """The answer envelope: exactly one of ``value`` (with the sealed
    ``version`` it was computed at) or ``error`` is meaningful, selected
    by ``ok``. ``latency_s`` is submit-to-answer, server-side.
    ``degraded`` marks an answer served while the write plane cannot
    seal (a shard fault): still correct — computed at the last published
    sealed snapshot, never a partial one — but possibly stale."""
    request_id: Union[int, str]
    ok: bool
    value: object = None
    version: Optional[Version] = None
    latency_s: float = 0.0
    error: Optional[QueryError] = None
    degraded: bool = False

    @classmethod
    def answered(cls, request_id, value, version: Version,
                 latency_s: float,
                 degraded: bool = False) -> "QueryResponse":
        return cls(request_id, True, value=value, version=version,
                   latency_s=latency_s, degraded=degraded)

    @classmethod
    def failed(cls, request_id, code: str, message: str = "",
               latency_s: float = 0.0) -> "QueryResponse":
        return cls(request_id, False, latency_s=latency_s,
                   error=QueryError(code, message))


@dataclasses.dataclass
class QueryResult:
    """One answered query: the query itself, its value, the snapshot
    ``version`` it was answered at, and the submit-to-answer latency."""
    query: Query
    value: object
    version: Version
    latency_s: float = 0.0


def query_fingerprint(q: Query, n: int) -> Optional[tuple]:
    """Canonical cache key for one query at a snapshot with ``n``
    vertices, or None for an unknown query type.

    Canonicalization makes semantically identical argument spellings
    share one entry: a falsy reachability hop bound (``None`` or ``0``)
    means "unbounded" on every execution path, so both spell the same
    key; a degree top-k larger than ``n`` returns all ``n`` vertices, so
    ``k`` clamps to ``n``. The snapshot version is NOT part of this
    fingerprint — the result cache keys the version as the outer dict, so
    sealing an epoch opens a fresh key space (invalidation by
    construction)."""
    if isinstance(q, KHop):
        return ("k_hop", int(q.source), int(q.k))
    if isinstance(q, Reachability):
        return ("reachability", int(q.src), int(q.dst),
                int(q.max_hops or 0))
    if isinstance(q, DegreeTopK):
        return ("degree_topk", min(int(q.k), int(n)), q.direction)
    if isinstance(q, PageRankQuery):
        return ("pagerank",
                None if q.top_k is None else int(q.top_k))
    return None


def query_touch_vertices(queries: Sequence[Query]) -> np.ndarray:
    """Vertex ids a query window touches — the access-pattern feed for the
    re-sharding planner.

    Point-query anchors count (k-hop sources, reachability endpoints);
    whole-graph queries (degree top-k, PageRank) touch every shard evenly
    and would only dilute the imbalance signal, so they contribute
    nothing. The serving layer bins these ids to shards via
    ``ShardedDynamicGraph.record_query_touches``. Returns an int64 array
    (possibly empty). Raises nothing: unknown query types are ignored
    here — ``SnapshotQueryEngine.execute`` is the layer that rejects
    them."""
    touched: list[int] = []
    for q in queries:
        if isinstance(q, KHop):
            touched.append(q.source)
        elif isinstance(q, Reachability):
            touched.append(q.src)
            touched.append(q.dst)
    return np.asarray(touched, np.int64)


@dataclasses.dataclass(frozen=True)
class _SubView:
    """Edge-restricted stand-in for a :class:`JoinView`: exactly the
    surface the batched frontier sweeps read (``n``/``m``/``src``/
    ``dst``), holding the routed edge subset instead of the global CSR —
    as tensors on the view's device, converted once in
    :meth:`SnapshotQueryEngine._route`."""
    n: int
    src: torch.Tensor
    dst: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.src.numel())


@dataclasses.dataclass(frozen=True)
class RoutedSnapshot:
    """Replica-first routing context for one serving snapshot: the
    snapshot's :class:`~repro_torch.graph.sharded.ReplicaPlan` plus the
    per-shard views it indexes. Built by the serving layer at publish
    (both pieces derive from the SAME sealed version — that pairing is
    the I10 coherence invariant) and handed to
    :meth:`SnapshotQueryEngine.execute`, which ignores it unless its
    version matches the view being queried (pinned replays at other
    versions fall back to the global view)."""
    plan: ReplicaPlan
    shard_views: list[JoinView]


_MISS = object()          # result-cache sentinel (None is a legal value)


def _freeze_result(val: object) -> object:
    """Make a to-be-memoized value safe to hand out by reference. Cache
    hits return the stored object itself, so an in-process caller that
    mutated a returned ndarray would poison every later hit at that
    version; marking arrays read-only (recursing into tuples) turns that
    silent corruption into an immediate ``ValueError`` at the caller."""
    if isinstance(val, np.ndarray):
        val.flags.writeable = False
    elif isinstance(val, tuple):
        for item in val:
            _freeze_result(item)
    return val
# shape signature memory: enough distinct (kind, static-arg, width)
# shapes for a realistic client mix, small enough that prewarm stays a
# few-millisecond background errand
MAX_WARM_SIGNATURES = 64


class SnapshotQueryEngine:
    """Answers query windows against one snapshot view, vectorized.

    ``pagerank_kw`` is forwarded to :func:`compute.pagerank` (damping, tol,
    max_iter); keep it fixed across a serving run so the warm-start
    chain stays meaningful.

    ``result_cache`` enables the versioned result cache (see module
    docs); ``result_cache_entries`` caps the per-version entry count —
    past it, new results are served but not memoized (counted in
    ``result_cache_evictions``), so one version of a high-cardinality
    query stream cannot pin unbounded memory.
    """

    def __init__(self, *, result_cache: bool = True,
                 result_cache_entries: int = 4096, **pagerank_kw):
        self.pagerank_kw = pagerank_kw
        self.result_cache = result_cache
        self.result_cache_entries = result_cache_entries
        self._rank_cache: dict[int, gc.PageRankResult] = {}
        # packed version -> {query fingerprint -> answered value}; the
        # versioned result cache (ladder-GC'd with the rank cache)
        self._result_cache: dict[int, dict[tuple, object]] = {}
        # serving runs queries on one thread while the ingest thread
        # prewarms/GCs the rank cache — this lock is the cache's own, so
        # cache integrity never depends on the server's coarser lock
        self._rank_lock = threading.Lock()
        # telemetry the serving benchmark and tests read — guarded by
        # _rank_lock too: concurrent flushers race on these counters
        self.vectorized_calls = {"k_hop": 0, "reachability": 0,
                                 "degree_topk": 0, "pagerank": 0}
        self.rank_cache_hits = 0
        self.rank_warm_starts = 0
        self.rank_cold_starts = 0
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        self.result_cache_evictions = 0
        # shape signatures real windows hit (insertion-ordered, so
        # overflow drops the stalest) — what warm_traces() replays
        self._warm_signatures: dict[tuple, None] = {}
        # (signature, edge width) pairs already replayed: a signature is
        # only re-run when the snapshot's pow2 edge bucket steps (a new
        # width IS a new trace), so steady-state publishes cost nothing —
        # a replay executes the kernel for real, and burning a core on
        # sweeps whose traces are already warm starves serving on small
        # hosts for zero cache benefit
        self._warmed_traces: set[tuple] = set()
        # replica-plane telemetry (same lock): per frontier vertex, did
        # its adjacency come from a mirror; per routed group, how many
        # shards the frontier closure actually touched
        self.mirror_hits = 0
        self.mirror_misses = 0
        self.routed_windows = 0
        self.fanout_hist: dict[int, int] = {}

    # -- PageRank cache ----------------------------------------------------
    def pagerank(self, view: JoinView) -> gc.PageRankResult:
        """Ranks for ``view``'s version: cached per version; warm-started
        from the nearest older cached version's ranks when one exists.
        Thread-safe: the lock covers only cache reads/writes — the
        iteration itself runs outside it, so a concurrent GC or a
        cache-hit at another version never waits on rank compute. Two
        threads racing on the SAME uncached version may both compute it
        (deterministic result; first insert wins)."""
        key = view.version.pack()
        with self._rank_lock:
            cached = self._rank_cache.get(key)
            if cached is not None:
                self.rank_cache_hits += 1
                return cached
            self.vectorized_calls["pagerank"] += 1
            older = [k for k in self._rank_cache if k < key]
            base = self._rank_cache[max(older)] if older else None
        if base is not None:
            res = gc.incremental_pagerank(base, None, view,
                                          **self.pagerank_kw)
        else:
            res = gc.pagerank(view, **self.pagerank_kw)
        with self._rank_lock:
            if base is not None:
                self.rank_warm_starts += 1
            else:
                self.rank_cold_starts += 1
            return self._rank_cache.setdefault(key, res)

    def gc(self, keep_latest: int = 4, *, retire_below: int = 0) -> int:
        """Ladder-GC the per-version rank cache (same retention policy as
        the join-view caches: a version-spaced ladder, so any past version
        keeps a warm-start base within ~2x its distance from the
        frontier). Returns the number of entries dropped.

        ``retire_below`` (a packed version; the serving layer passes
        ``ShardedDynamicGraph.plan_floor()``) additionally drops every
        entry below it once a newer entry exists: after a re-sharding
        cutover those ranks are keyed by snapshots of a retired routing
        plan and will never be served again — but the newest one is
        retained until the first post-cutover ranks are cached, so the
        warm-start chain crosses the cutover instead of restarting cold.
        Thread-safe (holds the cache lock)."""
        with self._rank_lock:
            dropped = prune_retired(self._rank_cache, retire_below)
            dropped += prune_views(self._rank_cache, keep_latest)
            # the result cache rides the same ladder: whole key spaces
            # (versions) drop at once, entries never drop individually
            evicted = prune_retired(self._result_cache, retire_below)
            evicted += prune_views(self._result_cache, keep_latest)
            self.result_cache_evictions += evicted
            return dropped + evicted

    @property
    def cached_rank_versions(self) -> list[int]:
        with self._rank_lock:
            return sorted(self._rank_cache)

    def result_cache_stats(self) -> dict:
        """Snapshot of the result-cache telemetry (thread-safe):
        hit/miss/eviction counters, live entry count across every cached
        version, and the hit rate over all lookups so far."""
        with self._rank_lock:
            total = self.result_cache_hits + self.result_cache_misses
            return {"hits": self.result_cache_hits,
                    "misses": self.result_cache_misses,
                    "evictions": self.result_cache_evictions,
                    "entries": sum(len(s)
                                   for s in self._result_cache.values()),
                    "hit_rate": self.result_cache_hits / max(total, 1)}

    def has_cached_result(self, version: Version, q: Query,
                          n: Optional[int] = None) -> bool:
        """True when ``q``'s answer at ``version`` is already memoized —
        the serving layer's lane classifier asks this so an expensive-kind
        query that will be a dict lookup can ride the cheap lane. ``n``
        is the snapshot's vertex count (only degree-top-k fingerprints
        clamp on it; omitting it leaves k unclamped). Thread-safe; a
        False answer may race a concurrent insert (the query then just
        executes on the expensive lane, still correct)."""
        fp = query_fingerprint(q, n if n is not None else 1 << 30)
        if fp is None:
            return False
        with self._rank_lock:
            slot = self._result_cache.get(version.pack())
            return slot is not None and fp in slot

    def replica_stats(self) -> dict:
        """Snapshot of the replica-routing telemetry (thread-safe)."""
        with self._rank_lock:
            total = self.mirror_hits + self.mirror_misses
            return {"mirror_hits": self.mirror_hits,
                    "mirror_misses": self.mirror_misses,
                    "mirror_hit_rate": self.mirror_hits / max(total, 1),
                    "routed_windows": self.routed_windows,
                    "fanout_hist": dict(self.fanout_hist)}

    def _route(self, routed: Optional[RoutedSnapshot], view: JoinView,
               anchors: np.ndarray, hops: Optional[int], *,
               record: bool = True) -> Optional[_SubView]:
        """Resolve one same-kind group through the replica plane, or None
        to fall back to the global view. The version check is the
        coherence gate: a RoutedSnapshot only ever speaks for its own
        sealed version, so a pinned replay at another version can never
        be answered from these mirrors."""
        if routed is None or routed.plan.version.pack() != view.version.pack():
            return None
        sub_src, sub_dst, fanout, hits, misses = replica_route(
            routed.plan, routed.shard_views, anchors, hops)
        # pow2-pad the routed subset on the host, with the kernels' own
        # phantom-row convention (src 0 gathers harmlessly, dst ``n`` is
        # the sliced-off segment). Routed edge counts vary per window —
        # handing raw lengths to ``_padded_edges`` would compile its
        # eager pad op once per distinct m; pre-bucketing collapses
        # routed windows onto a few stable shapes, so the replica path
        # keeps its traces warm even while the global CSR drifts
        width = gc.pad_pow2(sub_src.size)
        if width > sub_src.size:
            extra = width - sub_src.size
            sub_src = np.concatenate(
                [sub_src, np.zeros(extra, sub_src.dtype)])
            sub_dst = np.concatenate(
                [sub_dst, np.full(extra, view.n, sub_dst.dtype)])
        if record:
            # prewarm passes record=False: a trace-warming sweep must not
            # pollute the mirror-hit / fan-out telemetry real windows feed
            with self._rank_lock:
                self.mirror_hits += hits
                self.mirror_misses += misses
                self.routed_windows += 1
                self.fanout_hist[fanout] = \
                    self.fanout_hist.get(fanout, 0) + 1
        device = view.src.device
        return _SubView(view.n,
                        torch.from_numpy(np.ascontiguousarray(
                            sub_src, np.int32)).to(device),
                        torch.from_numpy(np.ascontiguousarray(
                            sub_dst, np.int32)).to(device))

    # -- window execution --------------------------------------------------
    def execute(self, view: JoinView, queries: Sequence[Query], *,
                routed: Optional[RoutedSnapshot] = None,
                use_cache: Optional[bool] = None) -> list[object]:
        """Answer a window of queries against ``view`` with one vectorized
        call per (kind, shape) group. Returns values aligned with
        ``queries``.

        With the result cache enabled (``use_cache`` overrides the
        engine-wide default), each query is first looked up under
        ``(view.version, fingerprint)`` — hits skip compute entirely and
        are byte-identical to the value originally computed at this
        version, because they ARE that value (the cached object itself;
        memoized ndarrays are marked read-only, so a caller that tried to
        mutate a hit would fault instead of poisoning the cache). The
        misses execute through the grouped path below and are then
        memoized, subject to the per-version entry cap.

        With ``routed`` (and only when it speaks for ``view``'s exact
        version), the frontier kernels (k-hop, reachability) run on the
        replica-routed edge subset instead of the global CSR — byte-
        identical answers (the subset contains every edge the sweep can
        read), touching only shards that own or mirror the frontier.
        Whole-graph kernels (degree top-k, PageRank) always use the
        global view."""
        cache_on = self.result_cache if use_cache is None else use_cache
        if not cache_on:
            return self._execute_groups(view, queries, routed)
        values: list[object] = [None] * len(queries)
        fps = [query_fingerprint(q, view.n) for q in queries]
        key = view.version.pack()
        misses: list[int] = []
        with self._rank_lock:
            slot = self._result_cache.get(key)
            for i, fp in enumerate(fps):
                hit = (slot.get(fp, _MISS)
                       if slot is not None and fp is not None else _MISS)
                if hit is not _MISS:
                    self.result_cache_hits += 1
                    values[i] = hit
                else:
                    self.result_cache_misses += 1
                    misses.append(i)
        if not misses:
            return values
        computed = self._execute_groups(
            view, [queries[i] for i in misses], routed)
        for i, val in zip(misses, computed, strict=True):
            values[i] = val
        with self._rank_lock:
            slot = self._result_cache.setdefault(key, {})
            for i in misses:
                fp = fps[i]
                if fp is None or fp in slot:
                    continue
                if len(slot) >= self.result_cache_entries:
                    # cap reached: serve but don't memoize (no point
                    # churning entries — a version's key space is
                    # short-lived; the ladder drops it whole)
                    self.result_cache_evictions += 1
                    continue
                slot[fp] = _freeze_result(values[i])
        return values

    def _record_signatures(self, khops, reaches, topks, n: int) -> None:
        """Remember the shape signatures this window hit so a later
        :meth:`warm_traces` can replay them against a new snapshot.
        Insertion-ordered with a cap: overflow drops the stalest."""
        sigs = []
        for k, idxs in khops.items():
            sigs.append(("k_hop", int(k), gc.pad_pow2(len(idxs))))
        for _max_hops, idxs in reaches.items():
            sigs.append(("reachability", gc.pad_pow2(len(idxs))))
        for (k, direction), _idxs in topks.items():
            sigs.append(("degree_topk", min(int(k), n), direction))
        if not sigs:
            return
        with self._rank_lock:
            for sig in sigs:
                self._warm_signatures.pop(sig, None)   # refresh recency
                self._warm_signatures[sig] = None
            while len(self._warm_signatures) > MAX_WARM_SIGNATURES:
                self._warm_signatures.pop(
                    next(iter(self._warm_signatures)))

    def warm_traces(self, view: JoinView,
                    routed: Optional[RoutedSnapshot] = None, *,
                    max_anchors: int = 8) -> int:
        """Publish-time trace prewarm: replay every recorded shape
        signature against ``view`` so the first real query after a seal
        finds its shapes warm. (The reference warms ``jit`` traces; the
        port runs eagerly, so a replay warms the CUDA caching allocator at
        the new bucket sizes instead.)

        A live stream grows the snapshot's pow2 edge bucket over time;
        whenever the bucket steps, every batched-kernel trace goes cold
        and the first window at the new bucket pays the retrace. Running
        the recorded signatures here (on the ingest side's background
        prewarm thread, against the freshly published immutable view)
        moves that cost off the query path. With ``routed``, the hottest
        ``max_anchors`` mirrored vertices additionally warm the
        replica-routed buckets (via :meth:`_route` with telemetry
        recording off — prewarm is invisible in the mirror stats).

        Idempotent and safe to race with queries or the next seal: it
        only reads the immutable snapshot and the shape caches, and
        touches no result-cache or telemetry state real windows read.
        A ``(signature, edge width)`` pair is replayed at most once —
        the width is the trace key, so replaying a combination that
        already ran would execute a full kernel sweep for a guaranteed
        warm-shape hit; steady-state publishes (no bucket step) are
        therefore near-free. Returns the number of replays executed
        (0 once everything recorded is warm at the current widths)."""
        with self._rank_lock:
            sigs = list(self._warm_signatures)
        hot = None
        if routed is not None \
                and routed.plan.version.pack() == view.version.pack() \
                and routed.plan.n_mirrored:
            hot = np.flatnonzero(routed.plan.mirrored)[:max_anchors] \
                .astype(np.int32)
        m = int(view.src.numel())
        warmed = 0

        def fresh(key):
            with self._rank_lock:
                if key in self._warmed_traces:
                    return False
                if len(self._warmed_traces) > 4096:   # distinct widths are
                    self._warmed_traces.clear()       # few; belt and braces
                self._warmed_traces.add(key)
            return True

        for sig in sigs:
            if sig[0] == "k_hop":
                _, k, width = sig
                anchors = np.zeros(width, np.int32)
                if fresh((sig, m)):
                    gc.batched_k_hop(view, anchors, k)
                    warmed += 1
                if hot is not None:
                    sub = self._route(routed, view, hot, k, record=False)
                    if sub is not None and fresh((sig, sub.m)):
                        gc.batched_k_hop(sub, anchors, k)
                        warmed += 1
            elif sig[0] == "reachability":
                _, width = sig
                anchors = np.zeros(width, np.int32)
                # src == dst, so the while_loop exits on round one: the
                # warm is the trace, not a graph sweep
                if fresh((sig, m)):
                    gc.batched_reachability(view, anchors, anchors, 1)
                    warmed += 1
                if hot is not None:
                    sub = self._route(routed, view, hot, 1, record=False)
                    if sub is not None and fresh((sig, sub.m)):
                        gc.batched_reachability(sub, anchors, anchors, 1)
                        warmed += 1
            elif sig[0] == "degree_topk":
                _, k, direction = sig
                if fresh((sig, m)):
                    gc.degree_topk(view, k, direction=direction)
                    warmed += 1
        return warmed

    def _execute_groups(self, view: JoinView, queries: Sequence[Query],
                        routed: Optional[RoutedSnapshot]) -> list[object]:
        """The grouped vectorized path under :meth:`execute` (one vectorized
        call per (kind, shape) group; no caching at this layer)."""
        values: list[object] = [None] * len(queries)

        khops: dict[int, list[int]] = {}        # k -> query indices
        reaches: dict[Optional[int], list[int]] = {}   # max_hops -> indices
        topks: dict[tuple[int, str], list[int]] = {}
        ranks: list[int] = []
        for i, q in enumerate(queries):
            if isinstance(q, KHop):
                khops.setdefault(q.k, []).append(i)
            elif isinstance(q, Reachability):
                # grouped by hop bound: answering a bounded query with a
                # bigger shared bound could flip False -> True
                reaches.setdefault(q.max_hops, []).append(i)
            elif isinstance(q, DegreeTopK):
                topks.setdefault((q.k, q.direction), []).append(i)
            elif isinstance(q, PageRankQuery):
                ranks.append(i)
            else:
                raise TypeError(f"unknown query type {type(q).__name__}")
        self._record_signatures(khops, reaches, topks, view.n)

        for k, idxs in khops.items():
            sources = np.asarray([queries[i].source for i in idxs], np.int32)
            target = self._route(routed, view, sources, k) or view
            reach = to_host(gc.batched_k_hop(target, sources, k))
            with self._rank_lock:
                self.vectorized_calls["k_hop"] += 1
            for row, i in enumerate(idxs):
                values[i] = reach[row]

        for max_hops, idxs in reaches.items():
            srcs = np.asarray([queries[i].src for i in idxs], np.int32)
            dsts = np.asarray([queries[i].dst for i in idxs], np.int32)
            # frontier expansion only ever walks forward from the
            # sources, so they alone anchor the route
            target = self._route(routed, view, srcs, max_hops) or view
            got = to_host(gc.batched_reachability(target, srcs, dsts,
                                                  max_hops))
            with self._rank_lock:
                self.vectorized_calls["reachability"] += 1
            for row, i in enumerate(idxs):
                values[i] = bool(got[row])

        for (k, direction), idxs in topks.items():
            ids, degs = gc.degree_topk(view, k, direction=direction)
            with self._rank_lock:
                self.vectorized_calls["degree_topk"] += 1
            pair = (to_host(ids), to_host(degs))
            for i in idxs:
                values[i] = pair

        if ranks:
            res = self.pagerank(view)
            full = to_host(res.ranks)
            for i in ranks:
                top_k = queries[i].top_k
                if top_k is None:
                    values[i] = full
                else:
                    ids = np.argsort(-full, kind="stable")[:top_k]
                    values[i] = (ids, full[ids])

        return values
