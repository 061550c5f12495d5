"""Graph query server: online queries on live sharded snapshots.

The paper's central claim is ONE evolving graph serving both offline
analytics and low-latency online queries. This is the online half wired
end to end: a :class:`GraphQueryServer` owns a ``ShardedDynamicGraph``,
keeps ingesting a mutation stream (cooperatively via :meth:`step`, or on a
background thread via :meth:`start_background_ingest`), and answers
typed :class:`~repro_torch.graph.query.QueryRequest` envelopes strictly against
**frontier-sealed snapshots** (``latest_sealed()`` — the global-frontier
rule; a partially-sealed epoch is never served). Query windows are
answered by the ``graph.query.SnapshotQueryEngine``: same-kind queries —
across every submitting client, in-process or RPC — collapse into one
vectorized call, PageRank is cached per snapshot version and
warm-started incrementally from the previous epoch's ranks, and both the
rank cache and the view caches are GC'd with the version-spaced
``ladder_keep`` retention so server memory stays bounded under churn.

**Epoch-pipelined reads (the seal-swap discipline).** Ingest and serving
no longer share one lock. The write plane (``_ingest_lock``) serializes
ingest/seal/re-shard/cache-GC; at every global seal the server stitches
the newly sealed epoch's view and *publishes* it — an atomic pointer swap
under the tiny read-plane lock (``_serve_lock``). Queries pin the
published immutable view and execute entirely outside the write plane, so
windows answer at sealed epoch *e* while epoch *e+1*'s shard applies run
(on the ``parallel_apply`` thread pool) — instead of queuing behind the
apply as they did when one RLock covered both planes. The only
lock-ordering rule is ``_ingest_lock`` → ``_serve_lock`` (publish);
nothing ever nests the other way (enforced by reprolint RL002).

The reference's network front (``launch/rpc.py``) is not ported yet; this
module's ``main`` runs the in-process serving loop.

This is layer 5 (the top) of the pipeline mapped in
``docs/ARCHITECTURE.md``, and the serving loop is also where dynamic
re-sharding closes its feedback loop: answered windows buffer their query
touches on the read plane, :meth:`GraphQueryServer.step` drains them into
the store's access ledger and runs the planner tick at its entry — the
between-epochs quiescent point, so a fired split's migration applies
inside the incoming batch's seal.

The store, its views and every kernel live on ``--device`` (default
``cuda``: the snapshot masks run the ``liveness_mask`` CUDA kernel and
every PageRank iteration the ``segment_sum`` kernel).

Usage (synthetic ingest-while-query loop):
    PYTHONPATH=src python -m repro_torch.launch.serve_graph --vertices 2000 \
        --epochs 8 --queries-per-epoch 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.replica import MirrorPlanner
from repro_torch.core.versioned import Version
from repro_torch.graph.dyngraph import (JoinView, MutationBatch, prune_retired,
                                  prune_views, synthesize_churn_stream)
from repro_torch.graph.query import (ERR_BAD_PIN, ERR_BAD_QUERY, ERR_DEADLINE,
                               ERR_OVERLOADED,
                               DegreeTopK, KHop, PageRankQuery, Query,
                               QueryRequest, QueryResponse, QueryResult,
                               Reachability, RoutedSnapshot,
                               SnapshotQueryEngine, query_kind,
                               query_touch_vertices)
from repro_torch.graph.sharded import ShardedDynamicGraph
from repro_torch.graph.wal import ShardFaultError

QUERY_KINDS = ("k_hop", "reachability", "degree_topk", "pagerank")

# lane classification for the two-lane scheduler: cheap kinds answer in
# one bounded vectorized sweep (or a cache hit); expensive kinds iterate to
# convergence (PageRank) or may walk the whole graph (cold unbounded
# reachability). An expensive-kind request whose answer is already
# memoized at its target version rides the cheap lane too — it is a dict
# lookup, and that is the whole point of the fast path.
LANES = ("cheap", "expensive")
CHEAP_KINDS = frozenset({"k_hop", "degree_topk"})


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """Frozen serving snapshot with stable field names (the dict-shaped
    ``stats()`` of earlier revisions is gone — benchmarks, examples and
    the RPC ``stats`` op all read these fields).

    ``queue_depth`` is the pending requests at sampling time;
    ``shed_overload`` / ``shed_deadline`` count typed load-shed and
    expired-budget responses; ``per_kind_latency_s`` maps each query kind
    to its ``{"p50", "p95", "p99"}`` submit-to-answer quantiles over the
    recent window (absent kinds were never served).

    Replica-plane telemetry: ``mirror_hits`` / ``mirror_misses`` count
    frontier vertices resolved from mirrors vs shards across every routed
    window; ``fanout_hist`` maps shards-touched-per-routed-group (as a
    string key, for the JSON wire) to occurrence count, ``mean_fanout``
    its mean (`-1.0` before any routed window); ``mirrored_vertices`` is
    the serving snapshot's mirror set size; ``split_events`` /
    ``merge_events`` count completed re-sharding cutovers of each kind.

    Fast-path telemetry: ``queue_depth_by_lane`` / ``per_lane_latency_s``
    break the queue and the quantiles down by scheduler lane;
    ``result_cache_*`` mirror the engine's versioned result cache
    (hits/misses/evictions, live entries, hit rate over all lookups);
    ``prewarm_runs`` counts completed publish-time trace prewarms.

    Degraded-mode telemetry (invariant I11): ``degraded`` is True while
    a failed seal leaves epochs pending — the server keeps answering at
    the last *published* sealed snapshot, never a partial one;
    ``stale_epochs`` is how many ingested epochs the serving frontier
    lags; ``seal_failures`` counts failed seal attempts over the
    server's lifetime (it never resets on recovery)."""
    served: int
    windows: int
    queue_depth: int
    shed_overload: int
    shed_deadline: int
    serving_version: Optional[Version]
    global_frontier: int
    n_shards: int
    routing_plan_id: Optional[int]
    reshard_events: tuple
    query_p50_s: float
    query_p95_s: float
    query_p99_s: float
    per_kind_latency_s: Mapping[str, Mapping[str, float]]
    published_views: int
    cached_stitched_views: int
    cached_rank_versions: int
    vectorized_calls: Mapping[str, int]
    rank_cache_hits: int
    rank_warm_starts: int
    rank_cold_starts: int
    mirror_hits: int
    mirror_misses: int
    mirror_hit_rate: float
    routed_windows: int
    fanout_hist: Mapping[str, int]
    mean_fanout: float
    mirrored_vertices: int
    split_events: int
    merge_events: int
    queue_depth_by_lane: Mapping[str, int]
    per_lane_latency_s: Mapping[str, Mapping[str, float]]
    result_cache_hits: int
    result_cache_misses: int
    result_cache_hit_rate: float
    result_cache_entries: int
    result_cache_evictions: int
    prewarm_runs: int
    degraded: bool = False
    stale_epochs: int = 0
    seal_failures: int = 0


@dataclasses.dataclass
class _Entry:
    """One queued request on the read plane: the typed envelope, its
    submission timestamp (``perf_counter``), the absolute deadline derived
    from ``deadline_s`` (None = no budget), an optional completion
    callback — RPC handlers pass one so the scheduler can push the
    response back on the submitting connection; legacy ``submit()``
    entries have none and are returned by ``flush()`` — and the scheduler
    lane the request was classified into at submission."""
    request: QueryRequest
    enqueued_at: float
    deadline_at: Optional[float] = None
    on_done: Optional[Callable[[QueryResponse], None]] = None
    lane: str = "cheap"


def _quantiles(lat: np.ndarray) -> tuple[float, float, float]:
    if not lat.size:
        return 0.0, 0.0, 0.0
    p50, p95, p99 = (float(np.percentile(lat, q)) for q in (50, 95, 99))
    return p50, p95, p99


class GraphQueryServer:
    """Serves online graph queries while mutations stream into the shards.

    ``view_keep`` / ``rank_keep`` bound the stitched-view, published-view
    and PageRank caches (ladder retention); ``gc_every`` runs that GC
    every N sealed epochs so a long-lived server tracks the frontier
    instead of pinning every epoch it ever served. ``prewarm_pagerank``
    computes ranks eagerly after every :meth:`step` (warm-started from the
    previous epoch, outside the write lock so queries are never stalled
    behind it), keeping the warm chain unbroken even when PageRank queries
    are sparse.

    ``max_pending`` bounds the typed request queue — the admission-control
    half of the serving tier: :meth:`submit_request` load-sheds with an
    immediate ``ERR_OVERLOADED`` response instead of queueing without
    bound (the legacy ``submit()`` shim is exempt; in-process cooperative
    callers flush their own windows). ``pipeline_reads=False`` restores
    the pre-split discipline — every window pins its snapshot under the
    write lock and therefore queues behind in-flight applies — and exists
    so the serving benchmark can measure the seal-swap win against the
    real old behavior rather than a strawman.

    The server is also the access-pattern feed for dynamic re-sharding
    (``docs/ARCHITECTURE.md``): every answered window's touch vertices are
    buffered on the read plane, and :meth:`step` — the write plane's
    entry, where the store is guaranteed quiescent — drains them into the
    graph's ``AccessStats`` ledger and (when the graph was constructed
    with a ``ShardPlanner`` and ``auto_reshard`` is left on) runs the
    planner tick, so a fired split's migration applies inside the incoming
    batch's seal. Splits are appended to :attr:`reshard_events` as they
    fire; after a cutover the GC pass drops cache entries keyed by the
    retired routing plan (``plan_floor``) instead of aging them through
    the ladder.

    Thread-safety: ``_ingest_lock`` (re-entrant) serializes every touch of
    mutable graph/engine state (ingest, seal, re-shard, cache GC);
    ``_serve_lock`` guards only the read plane (pending queue, published
    snapshot pointer, serving counters). Query execution runs on published
    immutable views outside both locks, so ingestion never waits on query
    compute and queries never wait on applies.
    """

    def __init__(self, graph: ShardedDynamicGraph, *,
                 view_keep: int = 8, rank_keep: int = 4, gc_every: int = 1,
                 prewarm_pagerank: bool = False, auto_reshard: bool = True,
                 max_pending: int = 1024, pipeline_reads: bool = True,
                 replicate_hot: Optional[bool] = None, mirror_k: int = 64,
                 mirror_min_heat: float = 1.0,
                 two_lane: bool = True, expensive_budget: int = 16,
                 result_cache: bool = True,
                 result_cache_entries: int = 4096,
                 prewarm_traces: Optional[bool] = None,
                 max_touch_buffer: int = 65536,
                 **pagerank_kw):
        self.graph = graph
        self.engine = SnapshotQueryEngine(
            result_cache=result_cache,
            result_cache_entries=result_cache_entries, **pagerank_kw)
        self.view_keep = view_keep
        self.rank_keep = rank_keep
        self.gc_every = max(1, gc_every)
        self.prewarm_pagerank = prewarm_pagerank
        self.auto_reshard = auto_reshard
        self.max_pending = max_pending
        self.pipeline_reads = pipeline_reads
        # fast path knobs: two_lane splits the window queue by cost class
        # (the RPC tier runs one dispatcher per lane); expensive_budget
        # caps how many expensive entries one lane drain executes so a
        # PageRank convoy yields the engine back to the cheap lane.
        # prewarm_traces (default: on whenever reads are pipelined) warms
        # the shapes of the new serving snapshot off the publish path.
        self.two_lane = two_lane
        self.expensive_budget = max(1, expensive_budget)
        if prewarm_traces is None:
            prewarm_traces = pipeline_reads
        self.prewarm_traces = prewarm_traces
        self.max_touch_buffer = max_touch_buffer
        # replica plane: mirror the hottest vertices' adjacency at every
        # publish and route frontier queries replica-first. Defaults on
        # when the prerequisites hold — plan-based routing (the locality
        # index needs per-shard views keyed by the plan) and pipelined
        # reads (mirrors refresh at the publish boundary)
        if replicate_hot is None:
            replicate_hot = pipeline_reads and graph.plan is not None
        self.replicate_hot = replicate_hot
        self._mirror_planner = MirrorPlanner(mirror_k=mirror_k,
                                             min_heat=mirror_min_heat)
        self.reshard_events: list[dict] = []
        # degraded mode (invariant I11): epochs whose seal failed (they
        # stay pending on the store per I6 and re-seal later), plus a
        # lifetime failure counter — both under the write lock. The
        # read plane stamps responses from _degraded_hint, a lock-free
        # hint like _sealed_hint (at worst one window stamps stale).
        self._seal_backlog: list[int] = []
        self.seal_failures = 0
        self._degraded_hint = False
        # write plane: every touch of mutable graph/engine state
        self._ingest_lock = threading.RLock()
        # read plane: pending lane queues + published snapshot + counters
        self._serve_lock = threading.Lock()
        self._pending_cheap: list[_Entry] = []
        self._pending_expensive: list[_Entry] = []
        # (version, stitched view, replica routing context or None) — one
        # atomic pointer, so a window can never pair a view with another
        # version's mirrors (invariant I10)
        self._serving: Optional[
            tuple[Version, JoinView, Optional[RoutedSnapshot]]] = None
        # lock-free copy of the newest globally sealed version, refreshed
        # at every seal: the admission path's lane classifier reads it on
        # unpipelined servers so submission never touches the write lock
        # (an in-flight apply would stall the RPC reader otherwise)
        self._sealed_hint: Optional[Version] = None
        self._published: dict[int, JoinView] = {}
        # bounded ring of touch arrays (drop-oldest past max_touch_buffer
        # total ids): a serving-only server with no ingest tick to drain
        # it must not accumulate query touches forever
        self._touch_buffer: collections.deque[np.ndarray] = \
            collections.deque()
        self._touch_buffered = 0
        self._seals = 0
        self.windows = 0
        self.shed_overload = 0
        self.shed_deadline = 0
        # bounded: stats() percentiles are over the most recent window, and
        # a long-lived server does not accumulate per-query floats forever
        self.latencies_s: collections.deque[float] = \
            collections.deque(maxlen=8192)
        self._kind_latencies: dict[str, collections.deque] = {
            k: collections.deque(maxlen=2048) for k in QUERY_KINDS}
        self._lane_latencies: dict[str, collections.deque] = {
            lane: collections.deque(maxlen=4096) for lane in LANES}
        self.served = 0
        self._auto_ids = itertools.count(1)
        # dispatcher wake signals: work_available is the any-lane event
        # (legacy single-dispatcher waiters); work_cheap / work_expensive
        # wake the two-lane RPC dispatchers independently
        self.work_available = threading.Event()
        self.work_cheap = threading.Event()
        self.work_expensive = threading.Event()
        self.ingest_thread: Optional[threading.Thread] = None
        # publish-time trace prewarm: a single persistent daemon worker
        # coalesces to the newest published snapshot (_prewarm_target is a
        # one-slot mailbox under its own lock; the wake event is set by
        # _publish and cleared by the worker before reading the slot)
        self._prewarm_lock = threading.Lock()
        self._prewarm_target: Optional[
            tuple[Version, JoinView, Optional[RoutedSnapshot]]] = None
        self._prewarm_wake = threading.Event()
        self._prewarm_stop = threading.Event()
        self._prewarm_thread: Optional[threading.Thread] = None
        self.prewarm_runs = 0
        graph.on_frontier_advance(self._on_seal)

    # -- ingestion side ----------------------------------------------------
    def _on_seal(self, frontier: int) -> None:
        # fires inside seal_epoch/seal_shard; re-entrant lock covers the
        # case of a caller sealing the graph directly, outside step()
        with self._ingest_lock:
            self._seals += 1
            self._sealed_hint = self.graph.latest_sealed()
            # publish BEFORE the GC pass: the stitch inserts the new
            # version into the view cache, and pruning after keeps the
            # cache at its bound the moment the seal returns (the ladder
            # always retains the newest entry — the serving snapshot)
            if self.pipeline_reads:
                self._publish()
            if self._seals % self.gc_every == 0:
                self.graph.gc_views(self.view_keep)
                self.engine.gc(self.rank_keep,
                               retire_below=self.graph.plan_floor())

    def _publish(self) -> None:
        """Seal-swap: stitch the newest sealed epoch's view on the write
        plane and swap it into the read plane's published pointer. The
        stitch (O(delta), cached per version) is paid once per seal by the
        ingest side so no query ever stitches — or waits for the write
        lock — on its hot path."""
        with self._ingest_lock:
            v = self.graph.latest_sealed()
            if v is None:
                return
            view = self.graph.join_view(v)
            floor = self.graph.plan_floor()
            routed = None
            if self.replicate_hot:
                # mirror refresh rides the publish: nominate from the
                # ledger's vertex heat, rebuild the plan from THIS sealed
                # version's own views — a mirror is exactly as fresh as
                # the snapshot it serves, never staler (invariant I10)
                hot = self._mirror_planner.nominate(
                    self.graph.access_stats.vertex_heat)
                plan = self.graph.build_replica_plan(v, hot)
                routed = RoutedSnapshot(plan, self.graph.shard_views(v))
        with self._serve_lock:
            self._serving = (v, view, routed)
            self._published[v.pack()] = view
            # same ladder retention as the graph-side caches, and retired
            # routing plans drop outright — but never the serving entry
            prune_retired(self._published, floor)
            prune_views(self._published, self.view_keep)
        if self.prewarm_traces:
            # hand the new snapshot to the prewarm worker (coalescing
            # one-slot mailbox: a faster seal cadence overwrites the slot
            # and the worker only ever warms the newest target)
            with self._prewarm_lock:
                self._prewarm_target = (v, view, routed)
            self._prewarm_wake.set()
            self._ensure_prewarm_thread()

    def _ensure_prewarm_thread(self) -> None:
        if self._prewarm_thread is not None or self._prewarm_stop.is_set():
            return
        t = threading.Thread(target=self._prewarm_loop, daemon=True,
                             name="trace-prewarm")
        self._prewarm_thread = t
        t.start()

    def _prewarm_loop(self) -> None:
        """Publish-time trace prewarm worker: replays the engine's
        recorded warm signatures (pow2-bucketed vectorized shapes, plus hot
        routed buckets when the snapshot ships a replica plan) against
        each newly published view, so the first query after a seal pays a
        dict lookup instead of a retrace. Best-effort by design — a
        prewarm failure must never take serving down with it."""
        while not self._prewarm_stop.is_set():
            self._prewarm_wake.wait()
            if self._prewarm_stop.is_set():
                return
            self._prewarm_wake.clear()
            with self._prewarm_lock:
                target, self._prewarm_target = self._prewarm_target, None
            if target is None:
                continue
            v, view, routed = target
            try:
                self.engine.warm_traces(view, routed)
            except Exception:
                continue
            with self._prewarm_lock:
                self.prewarm_runs += 1

    def stop_prewarm(self) -> None:
        """Stop the prewarm worker (idempotent; a later publish does NOT
        restart it). The worker is a daemon thread so calling this is
        optional hygiene — RPC ``stop()`` and tests use it for a clean
        teardown."""
        self._prewarm_stop.set()
        self._prewarm_wake.set()
        t = self._prewarm_thread
        if t is not None:
            t.join(timeout=5.0)

    def _drain_touches(self) -> None:
        """Move buffered query touches from the read plane into the
        graph's access ledger — called at step() entry, where the write
        lock is held and the store is quiescent."""
        with self._serve_lock:
            buffered = list(self._touch_buffer)
            self._touch_buffer.clear()
            self._touch_buffered = 0
        with self._ingest_lock:
            for ids in buffered:
                self.graph.record_query_touches(ids)

    def _maybe_prewarm(self) -> None:
        if not self.prewarm_pagerank:
            return
        with self._ingest_lock:
            v = self.graph.latest_sealed()
            if v is None:
                return
            view = self.graph.join_view(v)   # O(delta) stitch under lock
        # the PageRank iteration — the heaviest compute here — runs outside
        # the write lock (the engine's own cache lock suffices), so the
        # query side is never stalled behind a prewarm
        self.engine.pagerank(view)
        # the prewarm inserted the newest view/ranks AFTER the seal-time GC
        # pass; re-prune so the cache bounds hold after every step (the
        # ladder always retains the newest entry, so nothing useful drops)
        with self._ingest_lock:
            self.graph.gc_views(self.view_keep)
            floor = self.graph.plan_floor()
        self.engine.gc(self.rank_keep, retire_below=floor)

    def step(self, batch: MutationBatch) -> None:
        """Ingest one mutation batch and seal its epoch on every shard —
        the cooperative serving loop's ingestion tick. With
        ``prewarm_pagerank`` the epoch's ranks are warmed here, after the
        seal releases the lock.

        This is also where the read plane feeds back into the write plane:
        buffered query touches drain into the access ledger, and with
        ``auto_reshard`` (and a planner on the graph) the planner tick
        runs at step ENTRY — between epochs the store is quiescent, the
        only state a re-sharding cutover may activate from — so a split's
        migration always applies inside THIS batch's seal (the cutover
        epoch is the one about to be ingested), and a stream that simply
        stops can never strand a dispatched migration in a never-sealed
        epoch. Splits are recorded in :attr:`reshard_events`.

        A *failed* seal (an injected shard fault, or a capacity abort) is
        absorbed instead of propagated: the store's seal atomicity (I6)
        leaves the epoch cleanly pending, so the server marks itself
        degraded and keeps answering at the last published sealed
        snapshot — never a partial one (I11). Ingestion continues (the
        store's no-wait dispatch parks slices for the lagging shard), and
        the FIRST successful seal — the next healthy step, or an explicit
        :meth:`reseal` after ``FaultInjector.heal`` — catches up every
        backlogged epoch, because ``seal_epoch`` seals all lagging shards
        through its target. Ingest-side errors (bad version, malformed
        batch) still raise: they are caller bugs, not faults."""
        self._drain_touches()
        with self._ingest_lock:
            if self.auto_reshard:
                event = self.graph.maybe_reshard()
                if event is not None:
                    self.reshard_events.append(event)
            self.graph.ingest(batch)
            try:
                self.graph.seal_epoch(batch.version.epoch)
            except (ShardFaultError, MemoryError, OSError):
                self.seal_failures += 1
                if batch.version.epoch not in self._seal_backlog:
                    self._seal_backlog.append(batch.version.epoch)
                self._degraded_hint = True
                return
            if self._seal_backlog:
                # this seal closed every epoch <= batch's — including the
                # whole backlog (the frontier is the min local frontier)
                self._seal_backlog.clear()
                self._degraded_hint = False
        self._maybe_prewarm()

    def reseal(self) -> int:
        """Retry every pending seal (after ``FaultInjector.heal`` or
        operator intervention) without waiting for the next ingest tick.
        Returns the new global frontier. Raises — and stays degraded — if
        the fault persists; a no-op on a healthy server."""
        with self._ingest_lock:
            target = max([*self._seal_backlog,
                          *(n.local_frontier for n in self.graph.nodes)],
                         default=-1)
            if target < 0:
                return self.graph.coordinator.global_frontier
            frontier = self.graph.seal_epoch(target)
            self._seal_backlog.clear()
            self._degraded_hint = False
            return frontier

    def start_background_ingest(self, stream: Iterable[MutationBatch], *,
                                delay_s: float = 0.0) -> threading.Thread:
        """Drive :meth:`step` over ``stream`` on a daemon thread — queries
        keep flowing on the caller's thread while epochs seal behind the
        write lock. Returns the (started) thread; join it to wait for the
        stream to drain."""

        def pump():
            for batch in stream:
                self.step(batch)
                if delay_s:
                    time.sleep(delay_s)

        t = threading.Thread(target=pump, daemon=True,
                             name="graph-ingest")
        self.ingest_thread = t
        t.start()
        return t

    # -- query side (typed scheduler) --------------------------------------
    def latest_version(self) -> Optional[Version]:
        """Newest *published* sealed version (read plane, never blocks on
        ingest); falls back to the store when reads are unpipelined."""
        if self.pipeline_reads:
            with self._serve_lock:
                if self._serving is not None:
                    return self._serving[0]
            return None
        with self._ingest_lock:
            return self.graph.latest_sealed()

    def _classify(self, request: QueryRequest) -> str:
        """Lane classification at submission time. Cheap kinds (one
        bounded vectorized sweep) always ride the cheap lane; an expensive
        kind whose answer is already memoized at its target version is a
        dict lookup and rides the cheap lane too. The cache probe is a
        heuristic snapshot — at worst a stale probe puts one expensive
        execution on the cheap lane, which costs latency, never
        correctness. Runs on RPC reader threads, so it must never block
        on the write plane: pipelined servers read the published serving
        pointer (serve lock only), unpipelined ones the lock-free
        seal-time hint."""
        if not self.two_lane:
            return "cheap"
        kind = query_kind(request.query)
        if kind is None or kind in CHEAP_KINDS:
            return "cheap"
        target = request.pin_version
        if target is None:
            target = (self.latest_version() if self.pipeline_reads
                      else self._sealed_hint)
        if target is not None and self.engine.has_cached_result(
                target, request.query):
            return "cheap"
        return "expensive"

    def submit_request(self, request: QueryRequest,
                       on_done: Optional[Callable[[QueryResponse], None]]
                       = None) -> Optional[QueryResponse]:
        """Admission-controlled enqueue of one typed request.

        Returns None when the request was accepted (it will be answered by
        a subsequent window — via ``on_done`` if given, and/or in the
        return of the :meth:`run_window` call that executes it). Returns
        an immediate typed *response* — never raises — when the request
        cannot be queued: ``ERR_BAD_QUERY`` for an unknown query kind,
        ``ERR_OVERLOADED`` when the pending queues are at ``max_pending``
        (load shed; the caller sees it instantly instead of a timeout).

        The request is classified into its scheduler lane here (queues
        are physically separate); ``max_pending`` bounds the two lanes
        together so admission control is unchanged by the split.
        """
        if query_kind(request.query) is None:
            return QueryResponse.failed(
                request.request_id, ERR_BAD_QUERY,
                f"unknown query type {type(request.query).__name__}")
        lane = self._classify(request)
        now = time.perf_counter()
        deadline_at = (now + request.deadline_s
                       if request.deadline_s is not None else None)
        with self._serve_lock:
            if (len(self._pending_cheap) + len(self._pending_expensive)
                    >= self.max_pending):
                self.shed_overload += 1
                return QueryResponse.failed(
                    request.request_id, ERR_OVERLOADED,
                    f"pending queue at max_pending={self.max_pending}")
            queue = (self._pending_cheap if lane == "cheap"
                     else self._pending_expensive)
            queue.append(_Entry(request, now, deadline_at, on_done, lane))
        self.work_available.set()
        (self.work_cheap if lane == "cheap" else self.work_expensive).set()
        return None

    def run_window(self, lane: Optional[str] = None
                   ) -> list[tuple[QueryRequest, QueryResponse]]:
        """Drain pending work and answer it as ONE window — the single
        code path that owns execution and cache accounting for every
        submission surface (legacy ``submit``/``flush``, point
        :meth:`query`, and the RPC tier's dispatchers all land here, so
        same-kind queries collapse across clients into one vectorized call).

        ``lane=None`` (every in-process caller) drains BOTH lanes fully,
        merged back into submission order — identical semantics to the
        single-queue server. ``lane="cheap"`` drains only the cheap lane.
        ``lane="expensive"`` drains at most ``expensive_budget`` entries
        (plus any queued entry whose deadline already expired — those are
        shed as ``ERR_DEADLINE`` *now* instead of waiting out the convoy)
        and leaves the rest queued with ``work_expensive`` re-armed, so a
        PageRank flood yields the engine back to the cheap dispatcher
        between windows.

        Expired-deadline requests are answered with ``ERR_DEADLINE``
        without executing. Unpinned requests execute at the published
        serving snapshot; pinned requests at their pinned sealed version
        (published fast path, else a write-locked stitch; an unsealed pin
        is an ``ERR_BAD_PIN`` response). Completion callbacks run after
        the window, outside every lock; answered touch vertices are
        buffered (bounded, drop-oldest) for the next ingest tick.

        Legacy-compatible failure semantics: if nothing is globally
        sealed yet, the undeliverable entries are re-queued AHEAD of
        later submissions (each on its own lane) and ``RuntimeError``
        raises; if the engine fails mid-window, every live entry is
        re-queued un-answered and the error propagates — a window is
        delivered all-or-nothing.

        Returns ``(request, response)`` pairs in submission order.
        """
        now = time.perf_counter()
        leftovers = False
        with self._serve_lock:
            if lane is None:
                pending = sorted(
                    self._pending_cheap + self._pending_expensive,
                    key=lambda e: e.enqueued_at)
                self._pending_cheap = []
                self._pending_expensive = []
            elif lane == "cheap":
                pending = self._pending_cheap
                self._pending_cheap = []
            elif lane == "expensive":
                take: list[_Entry] = []
                rest: list[_Entry] = []
                for e in self._pending_expensive:
                    if len(take) < self.expensive_budget or (
                            e.deadline_at is not None
                            and now > e.deadline_at):
                        take.append(e)
                    else:
                        rest.append(e)
                pending = take
                self._pending_expensive = rest
                leftovers = bool(rest)
            else:
                raise ValueError(f"unknown lane {lane!r}")
            serving = self._serving
        if leftovers:
            # over-budget work stays queued; re-arm the dispatcher so the
            # next expensive window starts as soon as this one finishes
            self.work_expensive.set()
        if not pending:
            return []
        expired: list[tuple[_Entry, QueryResponse]] = []
        live: list[_Entry] = []
        for e in pending:
            if e.deadline_at is not None and now > e.deadline_at:
                expired.append((e, QueryResponse.failed(
                    e.request.request_id, ERR_DEADLINE,
                    f"deadline_s={e.request.deadline_s} expired in queue",
                    latency_s=now - e.enqueued_at)))
            else:
                live.append(e)
        if not self.pipeline_reads:
            # the pre-split discipline (benchmark baseline): pin the
            # snapshot under the write lock — behind in-flight applies
            with self._ingest_lock:
                v = self.graph.latest_sealed()
                serving = ((v, self.graph.join_view(v), None)
                           if v is not None else None)
        if serving is None and any(e.request.pin_version is None
                                   for e in live):
            # nothing answerable yet: re-queue AHEAD of anything submitted
            # since the swap so window order is preserved (nothing was
            # answered), deliver only the already-expired budgets
            with self._serve_lock:
                self._pending_cheap[:0] = [
                    e for e in live if e.lane == "cheap"]
                self._pending_expensive[:0] = [
                    e for e in live if e.lane != "cheap"]
                self.shed_deadline += len(expired)
            self._deliver(expired)
            raise RuntimeError(
                "no globally sealed snapshot yet — seal an epoch on "
                "every shard before querying")
        # group by effective snapshot so one engine call per (version,
        # kind) answers every client's same-kind queries together
        failed_pins: list[tuple[_Entry, QueryResponse]] = []
        groups: dict[int, list[_Entry]] = {}
        views: dict[int, tuple[Version, JoinView]] = {}
        routed = serving[2] if serving is not None else None
        for e in live:
            pin = e.request.pin_version
            if pin is None:
                v, view = serving[0], serving[1]
            else:
                v = pin
                packed = pin.pack()
                if packed not in views:
                    with self._serve_lock:
                        pinned = self._published.get(packed)
                    if pinned is None:
                        try:
                            with self._ingest_lock:
                                pinned = self.graph.join_view(pin)
                        except ValueError as exc:
                            failed_pins.append((e, QueryResponse.failed(
                                e.request.request_id, ERR_BAD_PIN,
                                str(exc))))
                            continue
                    views[packed] = (pin, pinned)
                view = views[packed][1]
            views.setdefault(v.pack(), (v, view))
            groups.setdefault(v.pack(), []).append(e)
        answered: dict[int, QueryResponse] = {}
        try:
            for packed in sorted(groups):
                v, view = views[packed]
                entries = groups[packed]
                # replica-first routing only for the serving snapshot the
                # mirrors were built for (the engine re-checks versions,
                # so a stale pairing degrades to the global view)
                values = self.engine.execute(
                    view, [e.request.query for e in entries],
                    routed=routed)
                done = time.perf_counter()
                for e, val in zip(entries, values, strict=True):
                    answered[id(e)] = QueryResponse.answered(
                        e.request.request_id, val, v, done - e.enqueued_at,
                        degraded=self._degraded_hint)
        except BaseException:
            # all-or-nothing: nothing from this window was delivered yet,
            # so re-queue every live entry (original order, each on its
            # own lane) for a retry and let the error surface — a failing
            # window is never silently discarded, and never
            # double-answered
            with self._serve_lock:
                self._pending_cheap[:0] = [
                    e for e in live if e.lane == "cheap"]
                self._pending_expensive[:0] = [
                    e for e in live if e.lane != "cheap"]
            raise
        ok_entries = [e for e in live if id(e) in answered]
        with self._serve_lock:
            self.windows += 1
            self.served += len(ok_entries)
            self.shed_deadline += len(expired)
            for e in ok_entries:
                lat = answered[id(e)].latency_s
                self.latencies_s.append(lat)
                self._kind_latencies[query_kind(e.request.query)].append(lat)
                self._lane_latencies[e.lane].append(lat)
            # access-pattern feed, buffered for the next ingest tick —
            # only AFTER the window succeeded, so a failing window
            # re-queued above cannot double-count touches on every retry.
            # Bounded drop-oldest: a serving-only server (no ingest tick
            # draining the buffer) must not grow it without bound
            touched = query_touch_vertices(
                [e.request.query for e in ok_entries])
            if touched.size:
                self._touch_buffer.append(touched)
                self._touch_buffered += int(touched.size)
                while (self._touch_buffered > self.max_touch_buffer
                       and len(self._touch_buffer) > 1):
                    dropped = self._touch_buffer.popleft()
                    self._touch_buffered -= int(dropped.size)
        pairs = []
        for e in pending:
            resp = answered.get(id(e))
            if resp is None:
                resp = next((r for x, r in expired + failed_pins
                             if x is e), None)
            if resp is not None:
                pairs.append((e, resp))
        self._deliver(pairs)
        return [(e.request, r) for e, r in pairs]

    @staticmethod
    def _deliver(pairs: Sequence[tuple[_Entry, QueryResponse]]) -> None:
        # completion callbacks run outside every lock: an RPC on_done
        # blocks on its connection's socket, never on the server
        for e, resp in pairs:
            if e.on_done is not None:
                e.on_done(resp)

    def query(self, q: Query) -> QueryResult:
        """Answer a single query through the SAME shared scheduler as
        every other path (it used to bypass window accounting): the
        request joins the pending window, :meth:`run_window` answers the
        whole window — collapsing it with any concurrently submitted
        same-kind queries — and this query's own response is returned.
        """
        done = threading.Event()
        box: dict[str, QueryResponse] = {}

        def on_done(resp: QueryResponse) -> None:
            box["resp"] = resp
            done.set()

        request = QueryRequest(query=q, request_id=next(self._auto_ids))
        shed = self.submit_request(request, on_done=on_done)
        if shed is not None:
            raise RuntimeError(f"query rejected: {shed.error.code} "
                               f"({shed.error.message})")
        while not done.is_set():
            self.run_window()
            if not done.is_set():
                # a concurrent window claimed the entry and is executing
                done.wait(0.002)
        resp = box["resp"]
        if not resp.ok:
            raise RuntimeError(
                f"query failed: {resp.error.code} ({resp.error.message})")
        return QueryResult(q, resp.value, resp.version, resp.latency_s)

    # -- deprecated shims ---------------------------------------------------
    def submit(self, query: Query) -> None:
        """DEPRECATED shim over :meth:`submit_request` (kept so existing
        examples/tests run unchanged; new code should submit typed
        :class:`~repro_torch.graph.query.QueryRequest` envelopes). Enqueues a
        bare query into the current window with no admission control, no
        deadline and no callback — answered at the next window run.
        Thread-safe: submitters may race each other and the flusher."""
        request = QueryRequest(query=query,
                               request_id=next(self._auto_ids))
        lane = self._classify(request)
        with self._serve_lock:
            queue = (self._pending_cheap if lane == "cheap"
                     else self._pending_expensive)
            queue.append(_Entry(request, time.perf_counter(), lane=lane))
        self.work_available.set()
        (self.work_cheap if lane == "cheap" else self.work_expensive).set()

    def flush(self) -> list[QueryResult]:
        """DEPRECATED shim over :meth:`run_window`: answer every pending
        query against the newest frontier-sealed snapshot and return the
        successful answers as legacy :class:`QueryResult`\\ s (error
        responses — expired deadlines, bad pins — are delivered through
        their callbacks but not returned here). Raises if nothing is
        globally sealed yet."""
        return [QueryResult(req.query, resp.value, resp.version,
                            resp.latency_s)
                for req, resp in self.run_window() if resp.ok]

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> ServerStats:
        """Serving snapshot as a frozen :class:`ServerStats`: latency
        quantiles (overall and per kind) over the recent window, queue
        depth and shed counters, cache sizes, vectorized-call and PageRank
        warm-start counters, plus re-sharding state. Thread-safe; the two
        planes are sampled one after the other, each under its own lock —
        consistent within a plane, not across them."""
        with self._ingest_lock:
            reshard_events = tuple(self.reshard_events)
            frontier = self.graph.coordinator.global_frontier
            cached_views = len(self.graph._views)
            n_shards = self.graph.n_shards
            plan = self.graph.plan
            split_events = sum(1 for m in self.graph.migrations
                               if m.get("kind", "split") == "split")
            merge_events = sum(1 for m in self.graph.migrations
                               if m.get("kind") == "merge")
            degraded = bool(self._seal_backlog)
            seal_failures = self.seal_failures
            last_ingested = (Version.unpack(self.graph._last_version).epoch
                             if self.graph._last_version >= 0 else -1)
            stale_epochs = max(0, last_ingested - frontier)
        replica = self.engine.replica_stats()
        hist = replica["fanout_hist"]
        total_routed = sum(hist.values())
        mean_fanout = (sum(k * c for k, c in hist.items()) / total_routed
                       if total_routed else -1.0)
        rcache = self.engine.result_cache_stats()
        with self._prewarm_lock:
            prewarm_runs = self.prewarm_runs
        with self._serve_lock:
            lat = np.asarray(self.latencies_s)
            p50, p95, p99 = _quantiles(lat)
            per_kind = {}
            for kind, dq in self._kind_latencies.items():
                if dq:
                    kp50, kp95, kp99 = _quantiles(np.asarray(dq))
                    per_kind[kind] = {"p50": kp50, "p95": kp95, "p99": kp99}
            per_lane = {}
            for lane, dq in self._lane_latencies.items():
                if dq:
                    lp50, lp95, lp99 = _quantiles(np.asarray(dq))
                    per_lane[lane] = {"p50": lp50, "p95": lp95, "p99": lp99}
            lane_depth = {"cheap": len(self._pending_cheap),
                          "expensive": len(self._pending_expensive)}
            serving = self._serving
            stats = ServerStats(
                served=self.served,
                windows=self.windows,
                queue_depth=(len(self._pending_cheap)
                             + len(self._pending_expensive)),
                shed_overload=self.shed_overload,
                shed_deadline=self.shed_deadline,
                serving_version=serving[0] if serving else None,
                global_frontier=frontier,
                n_shards=n_shards,
                routing_plan_id=plan.plan_id if plan is not None else None,
                reshard_events=reshard_events,
                query_p50_s=p50, query_p95_s=p95, query_p99_s=p99,
                per_kind_latency_s=per_kind,
                published_views=len(self._published),
                cached_stitched_views=cached_views,
                cached_rank_versions=len(self.engine.cached_rank_versions),
                vectorized_calls=dict(self.engine.vectorized_calls),
                rank_cache_hits=self.engine.rank_cache_hits,
                rank_warm_starts=self.engine.rank_warm_starts,
                rank_cold_starts=self.engine.rank_cold_starts,
                mirror_hits=replica["mirror_hits"],
                mirror_misses=replica["mirror_misses"],
                mirror_hit_rate=replica["mirror_hit_rate"],
                routed_windows=replica["routed_windows"],
                fanout_hist={str(k): c for k, c in sorted(hist.items())},
                mean_fanout=mean_fanout,
                mirrored_vertices=(serving[2].plan.n_mirrored
                                   if serving and serving[2] else 0),
                split_events=split_events,
                merge_events=merge_events,
                queue_depth_by_lane=lane_depth,
                per_lane_latency_s=per_lane,
                result_cache_hits=rcache["hits"],
                result_cache_misses=rcache["misses"],
                result_cache_hit_rate=rcache["hit_rate"],
                result_cache_entries=rcache["entries"],
                result_cache_evictions=rcache["evictions"],
                prewarm_runs=prewarm_runs,
                degraded=degraded,
                stale_epochs=stale_epochs,
                seal_failures=seal_failures)
        return stats


def _demo_queries(rng: np.random.Generator, n: int,
                  count: int) -> Sequence[Query]:
    qs: list[Query] = []
    for _ in range(count):
        roll = rng.random()
        if roll < 0.5:
            qs.append(KHop(int(rng.integers(0, n)), k=2))
        elif roll < 0.8:
            qs.append(Reachability(int(rng.integers(0, n)),
                                   int(rng.integers(0, n)), max_hops=8))
        elif roll < 0.95:
            qs.append(DegreeTopK(8))
        else:
            qs.append(PageRankQuery(top_k=8))
    return qs




def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--adds-per-epoch", type=int, default=1_000)
    ap.add_argument("--delete-frac", type=float, default=0.2,
                    help="fraction of the live edges each epoch deletes")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--queries-per-epoch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device for the store, views and kernels")
    ap.add_argument("--wal-dir", type=str, default=None,
                    help="durability directory (write-ahead log + graph "
                         "checkpoints); survive kill -9 and resume with "
                         "--recover")
    ap.add_argument("--recover", action="store_true",
                    help="recover the store from --wal-dir and resume the "
                         "stream after the durable frontier")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="graph checkpoint cadence in sealed epochs "
                         "(with --wal-dir)")
    args = ap.parse_args()

    batches = synthesize_churn_stream(args.vertices, args.epochs,
                                      args.adds_per_epoch, seed=args.seed,
                                      delete_frac=args.delete_frac)
    e_max = sum(len(b.add_src) for b in batches) + 16
    if args.recover:
        if not args.wal_dir:
            ap.error("--recover needs --wal-dir")
        sg = ShardedDynamicGraph.recover(args.wal_dir, device=args.device)
        start = sg.coordinator.global_frontier + 1
        batches = [b for b in batches if b.version.epoch >= start]
        print(f"recovered at durable frontier {start - 1}; resuming "
              f"{len(batches)} remaining epochs", flush=True)
    else:
        sg = ShardedDynamicGraph(args.shards, args.vertices, e_max,
                                 wal_dir=args.wal_dir,
                                 checkpoint_every=args.checkpoint_every,
                                 device=args.device)
    server = GraphQueryServer(sg, prewarm_pagerank=True,
                              tol=1e-6, max_iter=200)

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    for batch in batches:
        server.step(batch)                      # ingestion tick
        for q in _demo_queries(rng, args.vertices,
                               args.queries_per_epoch):
            server.submit(q)
        results = server.flush()                # one vectorized window
        v = results[0].version if results else None
        print(f"epoch {batch.version.epoch}: answered {len(results)} "
              f"queries @ snapshot {v}")
    wall = time.perf_counter() - t0
    server.stop_prewarm()
    s = server.stats()
    print(f"\nserved {s.served} queries over {args.epochs} epochs "
          f"in {wall:.2f}s on {sg.device}")
    print(f"  p50={s.query_p50_s*1e3:.2f}ms p95={s.query_p95_s*1e3:.2f}ms "
          f"p99={s.query_p99_s*1e3:.2f}ms")
    print(f"  vectorized calls: {dict(s.vectorized_calls)} "
          f"(vs {s.served} queries)")
    print(f"  pagerank warm starts: {s.rank_warm_starts}, "
          f"cold: {s.rank_cold_starts}, cache hits: {s.rank_cache_hits}")
    print(f"  bounded caches: {s.cached_stitched_views} views, "
          f"{s.published_views} published, "
          f"{s.cached_rank_versions} rank versions")


if __name__ == "__main__":
    main()
