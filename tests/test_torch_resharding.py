"""Live re-sharding in the port against the JAX reference: the same seeded
stream through both packages' ``ShardedDynamicGraph`` (the port on the
CPU), with the same splits, gives byte-identical stitched CSRs at every
version (pre-cutover ones re-queried afterwards too), the same reshard
events, plan histories and cache keys after GC, and the same served
answers across a cutover (PageRank within atol 1e-6). The cases mirror
``tests/test_resharding.py`` and the straggler and GC cases of
``tests/test_sharded.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_stores_same, assert_views_same,  # noqa: E402
                           both_streams, port_query, port_version,
                           same_answer)

from repro.core.replica import ShardPlanner as RPlanner  # noqa: E402
from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph.dyngraph import MutationBatch as RBatch  # noqa: E402
from repro.graph.query import (KHop, PageRankQuery, Reachability,  # noqa: E402
                               SnapshotQueryEngine as REngine)
from repro.graph.reference import LoopDynamicGraph  # noqa: E402
from repro.graph.sharded import AccessStats as RStats  # noqa: E402
from repro.graph.sharded import RoutingPlan as RPlan  # noqa: E402
from repro.graph.sharded import ShardedDynamicGraph as RSharded  # noqa: E402
from repro.graph.sharded import _mix64 as r_mix64  # noqa: E402
from repro.launch.serve_graph import GraphQueryServer as RServer  # noqa: E402
from repro_torch.core.replica import ShardPlanner as TPlanner  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph.dyngraph import MutationBatch as TBatch  # noqa: E402
from repro_torch.graph.query import SnapshotQueryEngine as TEngine  # noqa: E402
from repro_torch.graph.sharded import AccessStats as TStats  # noqa: E402
from repro_torch.graph.sharded import RoutingPlan as TPlan  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402
from repro_torch.graph.sharded import _mix64 as t_mix64  # noqa: E402
from repro_torch.launch.serve_graph import GraphQueryServer as TServer  # noqa: E402


def _pair(n_shards, n, e_max, **kw):
    """(port store on the CPU, reference store), built alike."""
    return (TSharded(n_shards, n, e_max, device="cpu", **kw),
            RSharded(n_shards, n, e_max, **kw))


def _batch(pkg, epoch, number=0, **arrays):
    """A hand-built batch of either package (``pkg`` "port" or "ref")."""
    cls, ver = (TBatch, TV) if pkg == "port" else (RBatch, RV)
    return cls(ver(epoch, number), **{k: np.asarray(v, np.int32)
                                      for k, v in arrays.items()})


def _apply_both(stores, **arrays_at):
    """Apply one hand-built batch to the (port, reference) pair."""
    epoch = arrays_at.pop("epoch")
    stores[0].apply(_batch("port", epoch, **arrays_at))
    stores[1].apply(_batch("ref", epoch, **arrays_at))


def assert_answers_same(queries, got, want) -> None:
    """Served answers equal: byte-identical, PageRank within atol 1e-6."""
    for q, a, w in zip(queries, got, want, strict=True):
        if isinstance(q, PageRankQuery):
            ga = a[1] if q.top_k else a
            wa = w[1] if q.top_k else w
            np.testing.assert_allclose(np.asarray(ga), np.asarray(wa),
                                       rtol=0, atol=1e-6)
        else:
            assert same_answer(a, w), q


# ------------------------------------------------- split/oracle equivalence
@pytest.mark.parametrize("parallel_apply", [0, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("delete_frac,readd_frac", [
    (0.0, 0.0),     # add-heavy
    (0.35, 0.4),    # churny: deletes + re-adds cross the migrated range
])
def test_midstream_split_matches_reference(n_shards, delete_frac, readd_frac,
                                           parallel_apply):
    """Two mid-stream splits: the port's stitched CSRs equal the
    reference store's and the loop oracle's at EVERY version, the
    migrations and vertex tables agree (the parallel apply plane too)."""
    n, epochs, adds = 48, 8, 60
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, adds,
                          seed=17, delete_frac=delete_frac,
                          readd_frac=readd_frac)
    tsg, rsg = _pair(n_shards, n, 8192, parallel_apply=parallel_apply)
    loop = LoopDynamicGraph(n, 8192)
    for e, (t, r) in enumerate(zip(tb, rb)):
        tsg.apply(t)
        rsg.apply(r)
        loop.apply(r)
        if e in (2, 5):
            assert tsg.shard_edge_counts() == rsg.shard_edge_counts()
            hot = int(np.argmax(rsg.shard_edge_counts()))
            assert tsg.split_shard(hot) == rsg.split_shard(hot)
    assert tsg.n_shards == rsg.n_shards == n_shards + 2
    assert tsg.migrations == rsg.migrations and len(tsg.migrations) == 2
    assert tsg.plan.history == rsg.plan.history
    assert_stores_same(tsg, rsg, range(epochs), loop)
    assert tsg.v_created.tobytes() == rsg.v_created.tobytes()
    assert tsg.v_type.tobytes() == rsg.v_type.tobytes()
    tsg.shutdown()
    rsg.shutdown()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_server_answers_identical_across_cutover(n_shards):
    """k-hop, reachability and warm-chained PageRank served by both
    packages' servers agree before, DURING (split activated, cutover
    epoch not sealed) and after a split."""
    n, epochs = 48, 6
    tb, rb = both_streams("synthesize_skewed_stream", n, epochs, 80,
                          seed=31, delete_frac=0.2)
    tsg, rsg = _pair(n_shards, n, 16384)
    tsrv = TServer(tsg, tol=1e-10, max_iter=200)
    rsrv = RServer(rsg, tol=1e-10, max_iter=200)
    qs = [KHop(3, 2), KHop(17, 2), Reachability(1, 40, 4), PageRankQuery()]

    def window():
        for q in qs:
            tsrv.submit(port_query(q))
            rsrv.submit(q)
        got, want = tsrv.flush(), rsrv.flush()
        assert [g.version.pack() for g in got] == \
            [w.version.pack() for w in want]
        assert_answers_same(qs, [g.value for g in got],
                            [w.value for w in want])
        return want[0].version

    for e, (t, r) in enumerate(zip(tb, rb)):
        tsrv.step(t)
        rsrv.step(r)
        assert window() == r.version
        if e == 2:
            hot = int(np.argmax(rsg.shard_edge_counts()))
            assert tsg.split_shard(hot) == rsg.split_shard(hot)
            assert window() == r.version        # during the cutover
    assert tsg.n_shards == rsg.n_shards == n_shards + 1
    assert tsg.migrations == rsg.migrations
    assert tsg.migrations[0]["migrated_edges"] > 0


def test_migration_merges_with_user_batch_at_cutover_version():
    """The hand-built cutover: a user batch at exactly ``(activation, 0)``
    merges with the migration slice in arrival order; later deletes of a
    migrated key route to the target. Both packages alike."""
    stores = _pair(2, 16, 64)
    loop = LoopDynamicGraph(16, 64)
    b0 = dict(add_src=[0, 1, 0, 2], add_dst=[3, 3, 3, 5])
    _apply_both(stores, epoch=0, **b0)
    loop.apply(_batch("ref", 0, **b0))
    pre = [s.shard_edge_counts() for s in stores]
    summaries = [s.split_shard(1) for s in stores]
    assert summaries[0] == summaries[1]
    assert summaries[0]["activation_epoch"] == 1
    assert summaries[0]["migrated_edges"] == 3
    for s, p in zip(stores, pre):
        assert s.shard_edge_counts() == p + [0]   # dispatched, not applied
        assert s.latest_sealed().pack() == RV(0, 0).pack()
    assert_stores_same(*stores, [0], loop)
    b1 = dict(add_src=[0, 7], add_dst=[3, 5], del_src=[0, 0], del_dst=[3, 3])
    _apply_both(stores, epoch=1, **b1)
    loop.apply(_batch("ref", 1, **b1))
    assert_stores_same(*stores, [0, 1], loop)
    assert stores[0].shards[2].n_edges == stores[1].shards[2].n_edges > 0
    b2 = dict(del_src=[1], del_dst=[3])
    _apply_both(stores, epoch=2, **b2)
    loop.apply(_batch("ref", 2, **b2))
    assert_stores_same(*stores, [0, 1, 2], loop)
    for f in ("src", "dst", "created", "deleted"):
        for i in range(3):
            assert getattr(stores[0].shards[i], f).tobytes() == \
                getattr(stores[1].shards[i], f).tobytes(), (f, i)


def _preconditions(pkg):
    """Run the split preconditions of ``tests/test_resharding.py`` on one
    package; returns what each step gave (errors by message)."""
    Sharded = TSharded if pkg == "port" else RSharded
    Planner = TPlanner if pkg == "port" else RPlanner
    kw = {"device": "cpu"} if pkg == "port" else {}
    out = []

    def attempt(fn):
        try:
            res = fn()
        except (RuntimeError, ValueError) as exc:
            out.append((type(exc).__name__, str(exc)))
        else:
            out.append(res)

    sg = Sharded(2, 8, 64, **kw)
    sg.ingest(_batch(pkg, 0, add_src=[0], add_dst=[1]))
    out.append(sg.is_quiescent())
    attempt(lambda: sg.split_shard(0))
    attempt(sg.maybe_reshard)
    sg.seal_epoch(0)
    out.append(sg.is_quiescent())
    attempt(lambda: sg.split_shard(0))
    sg.ingest(_batch(pkg, 1, add_src=[2], add_dst=[3]))
    sg.seal_shard(1, 1)
    out.append(sg.is_quiescent())
    sg2 = Sharded(2, 16, 64, **kw)
    sg2.apply(_batch(pkg, 0, add_src=[0, 1, 0], add_dst=[3, 3, 5]))
    attempt(lambda: sg2.split_shard(1))
    out.append(sg2.is_quiescent())
    attempt(lambda: sg2.split_shard(1))      # back to back: refused
    sg2.apply(_batch(pkg, 1, add_src=[2], add_dst=[7]))
    attempt(lambda: sg2.split_shard(1))
    sg2.apply(_batch(pkg, 2, add_src=[4], add_dst=[9]))
    custom = Sharded(2, 8, 64, route=lambda k: k % 2, **kw)
    attempt(lambda: custom.split_shard(0))
    attempt(custom.maybe_reshard)
    attempt(lambda: Sharded(2, 8, 64, route=lambda k: 0, planner=Planner(),
                            **kw))
    return out, sg2


def test_split_preconditions():
    """Quiescence, back-to-back splits and custom routes are refused the
    same way (same exception type and message) by both packages, and the
    store that split twice stitches alike."""
    got, tsg2 = _preconditions("port")
    want, rsg2 = _preconditions("ref")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            assert g == w, (g, w)
    assert [w for w in want if isinstance(w, tuple)], "nothing refused"
    assert_stores_same(tsg2, rsg2, range(3))


# ------------------------------------------------------------ GC regression
def test_split_drops_retired_plan_cache_entries():
    """After a split the retired plan's stitched views, the involved
    shards' views and PageRank ranks are dropped by the GC alike: the
    same counts, the same surviving cache keys, byte-identical views."""
    tb, rb = both_streams("synthesize_skewed_stream", 40, 6, 60, seed=7,
                          delete_frac=0.2)
    tsg, rsg = _pair(2, 40, 8192)
    teng = TEngine(tol=1e-8, max_iter=100)
    reng = REngine(tol=1e-8, max_iter=100)
    for t, r in zip(tb[:4], rb[:4]):
        tsg.apply(t)
        rsg.apply(r)
        teng.pagerank(tsg.join_view(t.version))
        reng.pagerank(rsg.join_view(r.version))
    assert tsg.plan_floor() == rsg.plan_floor() == 0
    hot = int(np.argmax(rsg.shard_edge_counts()))
    assert tsg.split_shard(hot) == rsg.split_shard(hot)
    floor = rsg.plan_floor()
    assert tsg.plan_floor() == floor == RV(4, 0).pack()
    assert tsg.gc_views(keep_latest=8) == rsg.gc_views(keep_latest=8) == 0
    assert teng.gc(8, retire_below=floor) == reng.gc(8, retire_below=floor)
    tsg.apply(tb[4])
    rsg.apply(rb[4])
    teng.pagerank(tsg.join_view(tb[4].version))
    reng.pagerank(rsg.join_view(rb[4].version))
    dropped = rsg.gc_views(keep_latest=8)
    assert tsg.gc_views(keep_latest=8) == dropped > 0
    assert teng.gc(8, retire_below=floor) == \
        reng.gc(8, retire_below=floor) > 0
    assert sorted(tsg._views) == sorted(rsg._views)
    for ts, rs in zip(tsg.shards, rsg.shards):
        assert sorted(ts._views) == sorted(rs._views)
    assert sorted(teng._rank_cache) == sorted(reng._rank_cache)
    assert_stores_same(tsg, rsg, range(5))
    assert teng.rank_cold_starts == reng.rank_cold_starts == 1


def test_gc_after_split_unpins_shard_batch_logs():
    """With no post-cutover view cached, the GC still bounds the involved
    shards' batch logs at the retired floor, alike in both packages."""
    tb, rb = both_streams("synthesize_skewed_stream", 40, 6, 60, seed=9,
                          delete_frac=0.2)
    tsg, rsg = _pair(2, 40, 8192)
    for t, r in zip(tb[:4], rb[:4]):
        tsg.apply(t)
        rsg.apply(r)
        tsg.shard_views(t.version)
        rsg.shard_views(r.version)
    hot = int(np.argmax(rsg.shard_edge_counts()))
    summary = rsg.split_shard(hot)
    assert tsg.split_shard(hot) == summary
    tsg.apply(tb[4])
    rsg.apply(rb[4])
    assert tsg.gc_views(keep_latest=8) == rsg.gc_views(keep_latest=8)
    floor = rsg.plan_floor()
    for ts, rs in zip(tsg.shards, rsg.shards):
        assert [(d.version, d.row_start, d.row_end, d.del_rows.tobytes())
                for d in ts._batch_log] == \
            [(d.version, d.row_start, d.row_end, d.del_rows.tobytes())
             for d in rs._batch_log]
        assert ts._log_floor == rs._log_floor
        assert sorted(ts._views) == sorted(rs._views)
    for i in (summary["source"], summary["target"]):
        assert all(r.version >= floor for r in tsg.shards[i]._batch_log)
    tsg.apply(tb[5])
    rsg.apply(rb[5])
    assert_stores_same(tsg, rsg, range(6))


def test_gc_floor_is_per_shard_not_global():
    """A later split of shard 1 keeps shard 0's views from after its own
    older split: both packages keep the same per-shard keys."""
    tb, rb = both_streams("synthesize_skewed_stream", 40, 9, 60, seed=19,
                          delete_frac=0.1)
    tsg, rsg = _pair(2, 40, 8192)
    for e, (t, r) in enumerate(zip(tb, rb)):
        tsg.apply(t)
        rsg.apply(r)
        if e in (1, 6):
            shard = 0 if e == 1 else 1
            assert tsg.split_shard(shard) == rsg.split_shard(shard)
        tsg.join_view(t.version)
        rsg.join_view(r.version)
    assert tsg.gc_views(keep_latest=16) == rsg.gc_views(keep_latest=16)
    for ts, rs in zip(tsg.shards, rsg.shards):
        assert sorted(ts._views) == sorted(rs._views)
    floor_a = RV(rsg.migrations[0]["activation_epoch"], 0).pack()
    floor_b = RV(rsg.migrations[1]["activation_epoch"], 0).pack()
    assert any(floor_a <= k < floor_b for k in tsg.shards[0]._views)
    assert_stores_same(tsg, rsg, range(9))


# ------------------------------------------------- planner + access ledger
def test_access_stats_and_planner_policy():
    """The access ledger's decay and the split planner's proposals and
    guard rails are the same numbers and decisions in both packages."""
    got = []
    for Stats, Planner in ((TStats, TPlanner), (RStats, RPlanner)):
        out = []
        stats = Stats(2, decay=0.5, query_weight=2.0)
        stats.record_mutations(np.array([100.0, 10.0]))
        stats.record_queries(np.array([0.0, 5.0]))
        out.append(stats.loads().tobytes())
        planner = Planner(imbalance_threshold=1.5, min_load=20.0,
                          min_epochs=2, max_shards=4)
        out.append(planner.propose(stats.loads(), epochs_observed=0))
        for f in (0, 1):
            stats.on_frontier_advance(f)
        out.append((stats.epochs_observed, stats.loads().tobytes()))
        d = planner.propose(stats.loads(),
                            epochs_observed=stats.epochs_observed)
        out.append((d.shard, d.reason))
        stats.on_frontier_advance(4)
        stats.on_frontier_advance(4)
        out.append((stats.epochs_observed, stats.loads().tobytes()))
        out.append(planner.propose([1.0, 0.5], epochs_observed=9))
        out.append(Planner(max_shards=2).propose([100.0, 1.0],
                                                 epochs_observed=9))
        out.append(planner.propose([30.0, 29.0], epochs_observed=9))
        with pytest.raises(ValueError, match="imbalance_threshold"):
            Planner(imbalance_threshold=1.0)
        stats.reset(3)
        out.append((stats.epochs_observed, stats.loads().tolist()))
        got.append(out)
    assert got[0] == got[1]
    assert got[0][3][0] == 0 and got[0][1] is None


def _planned_run(pkg, n, batches, max_shards, serve: bool):
    """The skewed stream through a planner-carrying store of ``pkg``,
    ticked by ``maybe_reshard`` or by a server's ``step``."""
    Sharded, Planner, Server = ((TSharded, TPlanner, TServer)
                                if pkg == "port"
                                else (RSharded, RPlanner, RServer))
    kw = {"device": "cpu"} if pkg == "port" else {}
    planner = Planner(imbalance_threshold=1.2, min_load=100.0,
                      min_epochs=2, max_shards=max_shards)
    sg = Sharded(2, n, 16384, planner=planner, **kw)
    if not serve:
        events = []
        for b in batches:
            sg.apply(b)
            ev = sg.maybe_reshard()
            if ev is not None:
                events.append(ev)
        return sg, events, None
    server = Server(sg, tol=1e-6, max_iter=100)
    answers = []
    for b in batches:
        server.step(b)
        q = KHop(int(b.add_dst[0]), k=1)
        server.submit(port_query(q) if pkg == "port" else q)
        answers.extend(r.value for r in server.flush())
    return sg, list(server.reshard_events), (server.stats(), answers)


@pytest.mark.parametrize("serve", [False, True],
                         ids=["maybe_reshard", "server_auto_reshard"])
def test_planner_driven_splits_on_skewed_stream(serve):
    """A zipf stream trips the planner at the same epochs with the same
    reasons in both packages, ticked by hand or by the server's step;
    the stores stay byte-identical to each other and the loop oracle."""
    n, epochs = 64, 8
    tb, rb = both_streams("synthesize_skewed_stream", n, epochs, 200,
                          seed=13)
    max_shards = 6 if serve else 8
    tsg, tev, tsrv = _planned_run("port", n, tb, max_shards, serve)
    rsg, rev, rsrv = _planned_run("ref", n, rb, max_shards, serve)
    assert tev == rev and rev, "the skewed stream must split"
    assert tsg.plan.history == rsg.plan.history
    assert tsg.n_shards == rsg.n_shards == 2 + len(rev)
    acts = [e["activation_epoch"] for e in rev]
    assert all(b - a >= 2 for a, b in zip(acts, acts[1:]))
    loop = LoopDynamicGraph(n, 16384)
    for b in rb:
        loop.apply(b)
    assert_stores_same(tsg, rsg, range(epochs),
                       loop if not serve else None)
    if serve:
        (ts, ta), (rs, ra) = tsrv, rsrv
        assert ts.reshard_events == rs.reshard_events
        assert (ts.n_shards, ts.routing_plan_id) == \
            (rs.n_shards, rs.routing_plan_id) == (2 + len(rev), len(rev))
        assert all(same_answer(a, w) for a, w in zip(ta, ra))
        assert ts.split_events == rs.split_events == len(rev)


def test_failed_window_does_not_record_query_touches():
    """A window poisoned mid-execute buffers no touches; the retry
    buffers once and the ingest tick drains once, in both packages."""
    got = []
    for pkg, Sharded, Server in (("port", TSharded, TServer),
                                 ("ref", RSharded, RServer)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        sg = Sharded(2, 16, 64, **kw)
        server = Server(sg)
        server.step(_batch(pkg, 0, add_src=[0], add_dst=[1]))
        q = KHop(1, k=1)
        server.submit(port_query(q) if pkg == "port" else q)
        server.submit("not a query")
        with pytest.raises(TypeError):
            server.flush()
        out = [len(server._touch_buffer)]
        server._pending_cheap = [e for e in server._pending_cheap
                                 if not isinstance(e.request.query, str)]
        server.flush()
        out.append(len(server._touch_buffer))
        server._drain_touches()
        out.append(float(sg.access_stats.queries.sum()))
        server._drain_touches()
        out.append(float(sg.access_stats.queries.sum()))
        out.append(sg.access_stats.loads().tobytes())
        got.append(out)
    assert got[0] == got[1]
    assert got[0][:4] == [0, 1, 1.0, 1.0]


# ------------------------------------------------- routing plan determinism
def test_routing_plan_determinism_fixed_histories():
    """Both packages' routing plans assign every key to the same shard
    under the same split histories (and their replay), and mix keys the
    same way."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 40, 2048)
    assert t_mix64(keys).tobytes() == r_mix64(keys).tobytes()
    for n_base, hots in [(1, [0, 0, 0, 1]), (2, [1, 2, 1]),
                         (4, [3, 0, 4, 5, 0])]:
        tp, rp = TPlan.initial(n_base), RPlan.initial(n_base)
        for i, hot in enumerate(hots):
            tp, rp = tp.split(hot, i + 1), rp.split(hot, i + 1)
            assert tp.history == rp.history
            assert tp.assign(keys).tobytes() == rp.assign(keys).tobytes()
            assert tp.mergeable_pairs() == rp.mergeable_pairs()
        assert TPlan.replay(n_base, rp.history).assign(keys).tobytes() == \
            rp.assign(keys).tobytes()
        survivor, removed = rp.mergeable_pairs()[0]
        tm, rm = tp.merge(removed, 99), rp.merge(removed, 99)
        assert tm.history == rm.history
        assert tm.assign(keys).tobytes() == rm.assign(keys).tobytes()


# ----------------------------------------- stragglers and GC (test_sharded)
def test_straggler_shard_holds_frontier_and_catches_up():
    """No-wait dispatch parks a straggler's slice; the frontier and the
    views hold back until it seals, then stitch alike."""
    tb, rb = both_streams("synthesize_churn_stream", 32, 3, 40, seed=7,
                          delete_frac=0.3)
    got = []
    for sg, bs in zip(_pair(2, 32, 4096), (tb, rb)):
        out = []
        sg.ingest(bs[0])
        sg.seal_shard(1, 0)
        out.append(sg.coordinator.global_frontier)
        sg.ingest(bs[1])
        out.append(len(sg.ingest_node.blocked_batches) > 0)
        sg.seal_shard(1, 1)
        out.append(sg.coordinator.global_frontier)
        with pytest.raises(ValueError, match="not globally sealed"):
            sg.join_view(bs[0].version)
        sg.seal_shard(0, 1)
        out.append(sg.coordinator.global_frontier)
        sg.ingest(bs[2])
        sg.seal_epoch(2)
        out.append(len(sg.ingest_node.blocked_batches))
        got.append((out, sg))
    assert got[0][0] == got[1][0] == [-1, True, -1, 1, 0]
    loop = LoopDynamicGraph(32, 4096)
    for b in rb:
        loop.apply(b)
    assert_stores_same(got[0][1], got[1][1], range(3), loop)


def test_straggler_replays_parked_epochs_out_of_order():
    """Two parked slices delivered in reversed order still apply in
    version order, alike in both packages."""
    stores = _pair(1, 8, 64)
    _apply_both(stores, epoch=0, add_src=[6], add_dst=[7])
    b1 = dict(add_src=[0, 2], add_dst=[1, 3])
    b2 = dict(add_src=[4], add_dst=[1], del_src=[0], del_dst=[1])
    for pkg, sg in zip(("port", "ref"), stores):
        sg.ingest(_batch(pkg, 1, 0, **b1))
        sg.ingest(_batch(pkg, 1, 1, **b2))
        node = sg.nodes[0]
        assert len(node.pending_payloads[1]) == 2
        node.pending_payloads[1] = node.pending_payloads[1][::-1]
        sg.seal_epoch(1)
    loop = LoopDynamicGraph(8, 64)
    loop.apply(_batch("ref", 0, add_src=[6], add_dst=[7]))
    loop.apply(_batch("ref", 1, 0, **b1))
    loop.apply(_batch("ref", 1, 1, **b2))
    for v in (RV(1, 0), RV(1, 1)):
        assert_views_same(stores[0].join_view(port_version(v)),
                          stores[1].join_view(v), str(v))
        offsets, src, *_ = loop.join_view_arrays(v)
        assert np.array_equal(
            stores[0].join_view(port_version(v)).np_src, src)


def test_sharded_gc_views_prunes_caches():
    """The stitched cache's ladder GC keeps the same epochs in both
    packages, and dropped snapshots rebuild byte-identically."""
    tb, rb = both_streams("synthesize_churn_stream", 32, 10, 30, seed=9,
                          delete_frac=0.2)
    tsg, rsg = _pair(2, 32, 4096)
    for t, r in zip(tb, rb):
        tsg.apply(t)
        rsg.apply(r)
        tsg.join_view(t.version)
        rsg.join_view(r.version)
    assert len(tsg._views) == len(rsg._views) == 10
    assert tsg.gc_views(keep_latest=4) == rsg.gc_views(keep_latest=4) > 0
    kept = sorted(RV.unpack(k).epoch for k in tsg._views)
    assert kept == sorted(RV.unpack(k).epoch for k in rsg._views) \
        == [5, 7, 8, 9]
    assert_stores_same(tsg, rsg, range(10))
