"""The replica plane in the port against the JAX reference: cold-shard
merges, hot-vertex mirrors and replica-first routing through both
packages (the port on the CPU) from the same seeded streams. Stitched
CSRs, plan histories, merge and mirror decisions, routed edge sets and
answers are byte-identical, and so is the routing telemetry (mirror hits
and misses, fan-out). The cases mirror ``tests/test_replica_plane.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same, assert_stores_same,  # noqa: E402
                           both_streams, host, port_query, port_version,
                           same_answer)

from repro.core.replica import MirrorPlanner as RMirror  # noqa: E402
from repro.core.replica import ShardPlanner as RPlanner  # noqa: E402
from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph.query import KHop, Reachability  # noqa: E402
from repro.graph.query import RoutedSnapshot as RRouted  # noqa: E402
from repro.graph.query import SnapshotQueryEngine as REngine  # noqa: E402
from repro.graph.reference import LoopDynamicGraph  # noqa: E402
from repro.graph.sharded import RoutingPlan as RPlan  # noqa: E402
from repro.graph.sharded import ShardedDynamicGraph as RSharded  # noqa: E402
from repro.graph.sharded import replica_route as r_route  # noqa: E402
from repro.launch.serve_graph import GraphQueryServer as RServer  # noqa: E402
from repro_torch.core.replica import MirrorPlanner as TMirror  # noqa: E402
from repro_torch.core.replica import ShardPlanner as TPlanner  # noqa: E402
from repro_torch.graph import compute as tgc  # noqa: E402
from repro_torch.graph.query import RoutedSnapshot as TRouted  # noqa: E402
from repro_torch.graph.query import SnapshotQueryEngine as TEngine  # noqa: E402
from repro_torch.graph.query import _SubView as TSubView  # noqa: E402
from repro_torch.graph.sharded import RoutingPlan as TPlan  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402
from repro_torch.graph.sharded import replica_route as t_route  # noqa: E402
from repro_torch.launch.serve_graph import GraphQueryServer as TServer  # noqa: E402


def _pair(n_shards, n, e_max, **kw):
    return (TSharded(n_shards, n, e_max, device="cpu", **kw),
            RSharded(n_shards, n, e_max, **kw))


def _error(fn):
    """``(type name, message)`` of what ``fn`` raises, or its result."""
    try:
        return fn()
    except (RuntimeError, ValueError) as exc:
        return (type(exc).__name__, str(exc))


# ------------------------------------------------- merge/oracle equivalence
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("delete_frac,readd_frac", [
    (0.0, 0.0),     # add-heavy
    (0.35, 0.4),    # churny: deletes + re-adds cross the migrated range
])
def test_split_then_merge_matches_reference(n_shards, delete_frac,
                                            readd_frac):
    """A split, then a merge of the split pair: both packages' summaries,
    plan histories, retired sets and stitched CSRs at every version agree,
    and equal the loop oracle's."""
    n, epochs, adds = 48, 8, 60
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, adds,
                          seed=23, delete_frac=delete_frac,
                          readd_frac=readd_frac)
    tsg, rsg = _pair(n_shards, n, 8192)
    loop = LoopDynamicGraph(n, 8192)
    for e, (t, r) in enumerate(zip(tb, rb)):
        tsg.apply(t)
        rsg.apply(r)
        loop.apply(r)
        if e == 2:
            split = rsg.split_shard(0)
            assert tsg.split_shard(0) == split
        elif e == 5:
            merge = rsg.merge_shards(split["target"])
            assert tsg.merge_shards(split["target"]) == merge
            assert merge["kind"] == "merge" and merge["target"] == 0
    assert tsg.retired == rsg.retired == {split["target"]}
    assert tsg.plan.history == rsg.plan.history
    assert tsg.plan.n_shards == rsg.plan.n_shards == n_shards
    assert tsg.live_shards() == rsg.live_shards()
    assert_stores_same(tsg, rsg, range(epochs), loop)
    last = port_version(RV(epochs - 1, 0))
    assert tsg.shard_views(last)[split["target"]].m == 0
    keys = np.random.default_rng(0).integers(0, 1 << 40, 2048)
    assert tsg.plan.assign(keys).tobytes() == rsg.plan.assign(keys).tobytes()
    assert TPlan.replay(n_shards, tsg.plan.history).assign(keys).tobytes() \
        == RPlan.replay(n_shards, rsg.plan.history).assign(keys).tobytes()


def test_split_after_merge_allocates_fresh_shard_id():
    """A split after a merge creates the next physical shard in both."""
    tb, rb = both_streams("synthesize_churn_stream", 32, 6, 50, seed=7,
                          delete_frac=0.1)
    got = []
    for sg, bs in zip(_pair(2, 32, 8192), (tb, rb)):
        out = []
        for e, b in enumerate(bs):
            sg.apply(b)
            if e == 1:
                out.append(sg.split_shard(1))
            elif e == 3:
                out.append(sg.merge_shards(out[0]["target"]))
            elif e == 4:
                out.append(sg.split_shard(0))
        out.append((sg.n_shards, sorted(sg.retired), sg.plan.n_total,
                    sg.plan.n_shards, sg.plan.history))
        got.append((out, sg))
    assert got[0][0] == got[1][0]
    assert (got[0][0][0]["target"], got[0][0][2]["target"]) == (2, 3)
    assert_stores_same(got[0][1], got[1][1], range(6))


@pytest.mark.parametrize("case", ["no_sibling", "retired_and_double"])
def test_merge_preconditions(case):
    """Merges without a split sibling, of a retired shard, and splits of
    a retired shard are refused alike (type and message)."""
    got = []
    for pkg, sg in zip(("port", "ref"), _pair(2, 32, 4096)):
        tb, rb = both_streams("synthesize_churn_stream", 32, 5, 40, seed=3) \
            if case == "retired_and_double" else \
            both_streams("synthesize_churn_stream", 16, 1, 10, seed=1)
        bs = tb if pkg == "port" else rb
        out = []
        if case == "no_sibling":
            sg.apply(bs[0])
            out.append(_error(lambda: sg.merge_shards(0)))
            out.append(_error(lambda: sg.merge_shards(5)))
        else:
            for e, b in enumerate(bs):
                sg.apply(b)
                if e == 1:
                    s = sg.split_shard(0)
                elif e == 3:
                    sg.merge_shards(s["target"])
            out.append(_error(lambda: sg.merge_shards(s["target"])))
            out.append(_error(lambda: sg.split_shard(s["target"])))
        got.append(out)
    assert got[0] == got[1]
    assert all(isinstance(x, tuple) and x[0] == "ValueError"
               for x in got[0])


# --------------------------------------------------------- planner policy
def test_planner_merge_proposals_and_live_mask():
    """Merge proposals, their hysteresis and guards, and the live mask
    over retired shards decide alike in both packages."""
    calls = [
        ("propose_merge", [5.0, 100.0, 5.0], 3, [(0, 2)], None),
        ("propose_merge", [20.0, 100.0, 20.0], 3, [(0, 2)], None),
        ("propose_merge", [5.0, 100.0, 5.0], 1, [(0, 2)], None),
        ("propose_merge", [0.1, 0.5, 0.1], 3, [(0, 2)], None),
        ("propose_merge", [5.0, 100.0, 5.0], 3, [], None),
        ("propose", [100.0, 110.0, 0.0], 3, None, [True, True, False]),
        ("propose", [100.0, 110.0, 0.0], 3, None, None),
        ("propose_merge", [100.0, 110.0, 0.0], 3, [(0, 2)],
         [True, True, False]),
    ]
    got = []
    for Planner in (TPlanner, RPlanner):
        merge_p = Planner(min_load=10.0, min_epochs=2, merge_threshold=0.4)
        live_p = Planner(imbalance_threshold=1.5, min_load=10.0,
                         min_epochs=0)
        out = []
        for name, loads, epochs, pairs, live in calls:
            p = merge_p if live is None and name == "propose_merge" \
                else live_p
            kw = {"epochs_observed": epochs}
            if pairs is not None:
                kw["pairs"] = pairs
            if live is not None:
                kw["live"] = live
            d = getattr(p, name)(loads, **kw)
            out.append(None if d is None else
                       tuple(sorted((k, v) for k, v in vars(d).items())))
        got.append(out)
    assert got[0] == got[1]
    assert got[0][0] is not None and got[0][5] is None


def test_mirror_planner_nomination():
    """Top-k by heat, ties to the lower id, the min-heat floor: the same
    ids from both packages, over random heats too."""
    heat = np.array([0.0, 5.0, 1.0, 9.0, 5.0, 3.0])
    tm, rm = TMirror(mirror_k=3, min_heat=2.0), RMirror(mirror_k=3,
                                                        min_heat=2.0)
    assert_same(tm.nominate(heat), rm.nominate(heat), "nominate")
    assert host(tm.nominate(heat)).tolist() == [1, 3, 4]
    assert_same(tm.nominate(np.zeros(6)), rm.nominate(np.zeros(6)), "zeros")
    assert_same(TMirror(mirror_k=0).nominate(heat),
                RMirror(mirror_k=0).nominate(heat), "k=0")
    rng = np.random.default_rng(4)
    for _ in range(5):
        h = np.round(rng.random(200) * 8, 1)   # many ties
        assert_same(TMirror(mirror_k=16, min_heat=1.0).nominate(h),
                    RMirror(mirror_k=16, min_heat=1.0).nominate(h), "rand")


# ------------------------------------------- routed execution equivalence
def _routed_stores(seed, n=40, n_shards=4, epochs=5):
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, 60,
                          seed=seed, delete_frac=0.25, readd_frac=0.3)
    tsg, rsg = _pair(n_shards, n, 8192)
    for t, r in zip(tb, rb):
        tsg.apply(t)
        rsg.apply(r)
    v = rsg.latest_sealed()
    assert tsg.latest_sealed().pack() == v.pack()
    return tsg, rsg, v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replica_route_byte_identical(seed):
    """For every mirror-set size the two packages' replica plans and
    routed edge sets are byte-identical, with the same fan-out and hit
    counts, and the port's k-hop and reachability on its routed subset
    equal its global view's answers."""
    tsg, rsg, v = _routed_stores(seed)
    tv = port_version(v)
    g = tsg.join_view(tv)
    tviews, rviews = tsg.shard_views(tv), rsg.shard_views(v)
    rng = np.random.default_rng(seed)
    for k_hot in (0, 4, 40):
        hot = (rng.choice(40, size=k_hot, replace=False) if k_hot
               else np.zeros(0, np.int64))
        tp, rp = tsg.build_replica_plan(tv, hot), rsg.build_replica_plan(v,
                                                                          hot)
        assert tp.plan_id == rp.plan_id and tp.n_mirrored == k_hot
        for f in ("mirrored", "mirror_src", "mirror_dst", "src_presence"):
            assert_same(getattr(tp, f), getattr(rp, f), f)
        anchors = rng.integers(0, 40, 6).astype(np.int32)
        for k in (1, 2, 3):
            got = t_route(tp, tviews, anchors, k)
            want = r_route(rp, rviews, anchors, k)
            assert_same(got[0], want[0], "sub_src")
            assert_same(got[1], want[1], "sub_dst")
            assert got[2:] == want[2:]
            sub = TSubView(g.n, torch.from_numpy(got[0]),
                           torch.from_numpy(got[1]))
            assert_same(tgc.batched_k_hop(sub, anchors, k),
                        tgc.batched_k_hop(g, anchors, k), f"k={k}")
        srcs = anchors[:3]
        dsts = rng.integers(0, 40, 3).astype(np.int32)
        for hops in (2, None):
            got = t_route(tp, tviews, srcs, hops)
            want = r_route(rp, rviews, srcs, hops)
            assert got[2:] == want[2:]
            assert_same(got[0], want[0], "reach sub_src")
            sub = TSubView(g.n, torch.from_numpy(got[0]),
                           torch.from_numpy(got[1]))
            assert_same(tgc.batched_reachability(sub, srcs, dsts, hops),
                        tgc.batched_reachability(g, srcs, dsts, hops),
                        f"hops={hops}")
    tp = tsg.build_replica_plan(tv, np.arange(40))
    assert t_route(tp, tviews, np.array([1, 2, 3]), 1)[2:] == (0, 3, 0)


def test_engine_routed_execution_and_telemetry():
    """Routed execution answers like the reference engine's, counts the
    same routed windows, hits, misses and fan-outs, and ignores a routed
    context at another version."""
    tsg, rsg, v = _routed_stores(3)
    tv = port_version(v)
    routed = (TRouted(tsg.build_replica_plan(tv, np.arange(10)),
                      tsg.shard_views(tv)),
              RRouted(rsg.build_replica_plan(v, np.arange(10)),
                      rsg.shard_views(v)))
    qs = [KHop(2, k=1), KHop(5, k=1), Reachability(1, 30, max_hops=3)]
    teng, reng = TEngine(), REngine()
    got = teng.execute(tsg.join_view(tv), [port_query(q) for q in qs],
                       routed=routed[0])
    want = reng.execute(rsg.join_view(v), qs, routed=routed[1])
    assert all(same_answer(a, np.asarray(w) if not isinstance(w, bool)
                           else w) for a, w in zip(got, want))
    assert teng.replica_stats() == reng.replica_stats()
    assert teng.replica_stats()["routed_windows"] == 2
    older = RV(0, 0)
    teng2, reng2 = TEngine(), REngine()
    got2 = teng2.execute(tsg.join_view(port_version(older)),
                         [port_query(KHop(2, k=1))], routed=routed[0])
    want2 = reng2.execute(rsg.join_view(older), [KHop(2, k=1)],
                          routed=routed[1])
    assert same_answer(got2[0], np.asarray(want2[0]))
    assert teng2.replica_stats() == reng2.replica_stats()
    assert teng2.replica_stats()["routed_windows"] == 0


# ---------------------------------------------- I10 across plan churn
def test_mirror_coherence_across_split_and_merge():
    """A split, then a merge, with mirrors refreshed at every publish:
    the port's published mirrors are rows of their own snapshot, its
    routed answers equal the reference server's and its own no-replica
    server's, and the routing telemetry equals the reference's."""
    n, epochs = 48, 8
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, 60,
                          seed=11, delete_frac=0.3, readd_frac=0.4)
    tsg, rsg = _pair(2, n, 8192)
    tsrv = TServer(tsg, auto_reshard=False, mirror_k=16, mirror_min_heat=0.5)
    rsrv = RServer(rsg, auto_reshard=False, mirror_k=16, mirror_min_heat=0.5)
    plain_sg = TSharded(2, n, 8192, device="cpu")
    plain = TServer(plain_sg, replicate_hot=False, auto_reshard=False)
    rng = np.random.default_rng(5)
    hot_pool = rng.integers(0, 12, 6)
    answered = 0
    for e, (t, r) in enumerate(zip(tb, rb)):
        for srv, b in ((tsrv, t), (rsrv, r), (plain, t)):
            srv.step(b)
        if e == 2:
            split = rsg.split_shard(0)
            assert tsg.split_shard(0) == split
        elif e == 5:
            assert tsg.merge_shards(split["target"]) == \
                rsg.merge_shards(split["target"])
        with tsrv._serve_lock:
            v, _, routed = tsrv._serving
        if routed is not None:
            assert routed.plan.version.pack() == v.pack()
            gv = tsg.join_view(v)
            sel = routed.plan.mirrored[gv.np_src]
            assert_same(routed.plan.mirror_src, gv.np_src[sel], "mirror src")
            assert_same(routed.plan.mirror_dst, gv.np_dst[sel], "mirror dst")
        queries = [KHop(int(hot_pool[i % len(hot_pool)]), k=1 + i % 2)
                   for i in range(6)]
        queries.append(Reachability(int(hot_pool[0]),
                                    int(rng.integers(0, n)), max_hops=4))
        for q in queries:
            got = tsrv.query(port_query(q))
            want = rsrv.query(q)
            base = plain.query(port_query(q))
            assert got.version.pack() == want.version.pack() \
                == base.version.pack()
            w = want.value if isinstance(want.value, bool) \
                else np.asarray(want.value)
            assert same_answer(got.value, w), q
            assert same_answer(got.value, base.value), q
            answered += 1
    ts, rs = tsrv.stats(), rsrv.stats()
    for f in ("routed_windows", "mirror_hits", "mirror_misses",
              "mirror_hit_rate", "fanout_hist", "mean_fanout",
              "split_events", "merge_events", "mirrored_vertices"):
        assert getattr(ts, f) == getattr(rs, f), f
    assert (ts.routed_windows, ts.mirror_hits, ts.mirror_misses) == \
        (48, 73, 220)
    assert ts.split_events == 1 and ts.merge_events == 1
    assert ts.mean_fanout < tsg.n_shards
    assert answered == 8 * 7


# --------------------------------------------------- routing determinism
def _fingerprint(sg, v, heat, anchors, Mirror, route):
    hot = Mirror(mirror_k=8, min_heat=0.5).nominate(heat)
    rp = sg.build_replica_plan(v, hot)
    out = route(rp, sg.shard_views(v), anchors, 2)
    return (host(hot).tobytes(), out[0].tobytes(), out[1].tobytes(),
            *out[2:])


def test_routing_deterministic_fixed_ledgers():
    """Routing is a pure function of (plan, ledger): repeated calls agree,
    and the port's fingerprint equals the reference's."""
    tsg, rsg, v = _routed_stores(9)
    tv = port_version(v)
    rng = np.random.default_rng(9)
    for _ in range(5):
        heat = rng.random(40) * 10
        anchors = rng.integers(0, 40, 5)
        got = _fingerprint(tsg, tv, heat, anchors, TMirror, t_route)
        assert got == _fingerprint(tsg, tv, heat, anchors, TMirror, t_route)
        assert got == _fingerprint(rsg, v, heat, anchors, RMirror, r_route)


# ------------------------------------------ src placement for shard views
def test_partition_sharded_src_placement():
    """Re-bucketing the shard views by source range gives the reference's
    src-placed partition byte for byte, and scatter and hub modes agree
    with allgather, the reference's answer and the segment-sum oracle."""
    import jax
    import jax.numpy as jnp

    from repro.graph.partition import distributed_join_group_by as r_join
    from repro.graph.partition import partition_graph_sharded as r_part
    from repro_torch.graph.partition import distributed_join_group_by as t_join
    from repro_torch.graph.partition import partition_graph_sharded as t_part

    tsg, rsg, v = _routed_stores(21, n=48)
    tv = port_version(v)
    tpg = t_part(tsg.shard_views(tv), hub_k=4, placement="src")
    rpg = r_part(rsg.shard_views(v), hub_k=4, placement="src")
    assert tpg.placement == rpg.placement == "src"
    assert (tpg.n, tpg.n_parts, tpg.n_local) == (rpg.n, rpg.n_parts,
                                                 rpg.n_local)
    for f in ("src", "dst", "mask", "out_degree", "hubs", "is_hub"):
        assert_same(getattr(tpg, f), getattr(rpg, f), f)
    full = tsg.join_view(tv)
    assert int(host(tpg.mask).sum()) == full.m
    vals = np.arange(tpg.n, dtype=np.float32)
    tvals = torch.from_numpy(vals)
    base = t_join(tpg, tvals, mode="allgather")
    for mode in ("scatter", "hub"):
        np.testing.assert_allclose(host(t_join(tpg, tvals, mode=mode)),
                                   host(base), rtol=1e-6)
    oracle = np.zeros(tpg.n, np.float64)
    np.add.at(oracle, full.np_dst, vals[full.np_src])
    np.testing.assert_allclose(host(base), oracle, rtol=1e-6)
    # the reference computes on its one-device mesh from one shard
    tsg1, rsg1, v1 = _routed_stores(21, n=48, n_shards=1)
    mesh = jax.make_mesh((1,), ("data",))
    rpg1 = r_part(rsg1.shard_views(v1), hub_k=4, placement="src")
    tpg1 = t_part(tsg1.shard_views(port_version(v1)), hub_k=4,
                  placement="src")
    for mode in ("allgather", "scatter", "hub"):
        np.testing.assert_allclose(
            host(t_join(tpg1, tvals, mode=mode)),
            np.asarray(r_join(rpg1, jnp.asarray(vals), mesh, mode=mode)),
            rtol=1e-6)
    dst_pg = t_part(tsg.shard_views(tv), hub_k=4)
    with pytest.raises(ValueError, match="src-placed"):
        t_join(dst_pg, tvals, mode="scatter")
    with pytest.raises(ValueError, match="placement"):
        t_part(tsg.shard_views(tv), placement="bogus")
