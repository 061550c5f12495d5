"""The port's serving slice as a whole against the JAX reference: the same
stream and the same query windows through the reference
``GraphQueryServer`` and the port's (on the CPU) give the same answers —
byte-identical k-hop, reachability and top-k, PageRank within atol 1e-6 —
and a write-ahead log written by either package is recovered by the other.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import assert_views_same, port_query, same_answer  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph.dyngraph import synthesize_churn_stream  # noqa: E402
from repro.graph.query import PageRankQuery as RPageRank  # noqa: E402
from repro.graph.sharded import ShardedDynamicGraph as RSharded  # noqa: E402
from repro.launch import serve_graph as rsg  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RCkpt  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import query as tq  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402
from repro_torch.launch import serve_graph as tsg  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager as TCkpt  # noqa: E402

# the sizes of tests/test_serve_graph.py::_setup
N, EPOCHS, ADDS, SHARDS, SEED = 64, 5, 60, 3, 13


def test_server_answers_match_reference():
    batches = synthesize_churn_stream(N, EPOCHS, ADDS, seed=SEED,
                                      delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    ref = rsg.GraphQueryServer(RSharded(SHARDS, N, e_max),
                               prewarm_pagerank=True, tol=1e-6, max_iter=200)
    port = tsg.GraphQueryServer(TSharded(SHARDS, N, e_max, device="cpu"),
                                prewarm_pagerank=True, tol=1e-6, max_iter=200)
    rng = np.random.default_rng(SEED + 1)
    compared = 0
    try:
        for b in batches:
            ref.step(b)
            port.step(b)     # the port ingests the reference's own batches
            qs = list(rsg._demo_queries(rng, N, 12)) + [RPageRank()]
            for q in qs:
                ref.submit(q)
                port.submit(port_query(q))
            want = ref.run_window()
            got = port.run_window()
            assert len(got) == len(want) == len(qs)
            for (_, a), (_, b_) in zip(got, want):
                assert a.ok and b_.ok
                assert a.version.pack() == b_.version.pack()
            for q, (_, a), (_, w) in zip(qs, got, want):
                if isinstance(q, RPageRank):
                    got_ranks = a.value[1] if q.top_k else a.value
                    want_ranks = w.value[1] if q.top_k else w.value
                    np.testing.assert_allclose(got_ranks, want_ranks,
                                               rtol=0, atol=1e-6)
                else:
                    assert same_answer(a.value, w.value), q
                compared += 1
            v = b.version
            assert_views_same(port.graph.join_view(TV(v.epoch, v.number)),
                              ref.graph.join_view(v), f"stitched {v}")
        ps, rs = port.stats(), ref.stats()
        assert ps.served == rs.served and ps.seal_failures == 0
        assert ps.vectorized_calls == rs.vectorized_calls
        assert ps.rank_warm_starts == rs.rank_warm_starts
        assert ps.routed_windows == rs.routed_windows > 0
    finally:
        ref.stop_prewarm()
        port.stop_prewarm()
    assert compared == EPOCHS * 13


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_round_trip_between_packages(tmp_path, writer):
    n, epochs = 48, 6
    batches = synthesize_churn_stream(n, epochs, 40, seed=3, delete_frac=0.3)
    e_max = sum(len(b.add_src) for b in batches) + 16
    kw = dict(wal_dir=tmp_path, wal_fsync="always", checkpoint_every=2)
    if writer == "port":
        store = TSharded(2, n, e_max, device="cpu", **kw)
    else:
        store = RSharded(2, n, e_max, **kw)
    for b in batches[:5]:
        store.apply(b)
    store.wal.sync()
    if writer == "port":
        rec = RSharded.recover(tmp_path)
    else:
        rec = TSharded.recover(tmp_path, device="cpu")
    assert rec.coordinator.global_frontier == 4
    oracle = RSharded(2, n, e_max)
    for b in batches[:5]:
        oracle.apply(b)
    port_store = store if writer == "port" else rec
    ref_store = rec if writer == "port" else store
    for e in range(2, 5):
        assert_views_same(port_store.join_view(TV(e, 0)),
                          oracle.join_view(RV(e, 0)), f"{writer} e={e}")
        assert_views_same(port_store.join_view(TV(e, 0)),
                          ref_store.join_view(RV(e, 0)), f"{writer} e={e}")
    # the recovered store keeps ingesting like the oracle
    rec.apply(batches[5])
    oracle.apply(batches[5])
    got = rec.join_view((TV if writer == "reference" else RV)(5, 0))
    want = oracle.join_view(RV(5, 0))
    assert np.asarray(got.np_keys).tobytes() == want.np_keys.tobytes()


def test_checkpoint_keys_and_restore_cross_packages(tmp_path):
    state = {"b": [np.arange(3, dtype=np.int32), {"z": np.ones(2)}],
             "a": np.float32(2.5), "c": (np.zeros((2, 2), np.int64), None)}
    TCkpt(tmp_path / "port").save(state, epoch=1, step=0)
    RCkpt(tmp_path / "ref").save(state, epoch=1, step=0)
    with np.load(tmp_path / "port" / "ckpt_e1_s0.npz") as p, \
            np.load(tmp_path / "ref" / "ckpt_e1_s0.npz") as r:
        assert p.files == r.files
        for k in p.files:
            assert p[k].dtype == r[k].dtype and p[k].tobytes() == r[k].tobytes()
    like = {"b": [torch.zeros(3, dtype=torch.int32), {"z": np.zeros(2)}],
            "a": np.float32(0), "c": (np.zeros((2, 2), np.int64), None)}
    back = TCkpt(tmp_path / "ref").restore(like)
    assert isinstance(back["b"][0], torch.Tensor)
    assert back["b"][0].tolist() == [0, 1, 2]
    assert back["c"][1] is None and back["c"][0].dtype == np.int64


def test_main_serves_on_cpu_and_recovers(tmp_path, monkeypatch, capsys):
    argv = ["serve_graph", "--device", "cpu", "--vertices", "200",
            "--epochs", "3", "--adds-per-epoch", "150", "--delete-frac",
            "0.3", "--wal-dir", str(tmp_path), "--checkpoint-every", "2"]
    monkeypatch.setattr(sys, "argv", argv)
    tsg.main()
    out = capsys.readouterr().out
    assert "served 48 queries over 3 epochs" in out and "on cpu" in out
    monkeypatch.setattr(sys, "argv", argv + ["--recover"])
    tsg.main()
    assert "recovered at durable frontier" in capsys.readouterr().out


def test_routed_subview_holds_tensors_and_warm_traces_replays():
    """The port's ``_SubView`` carries device tensors (converted once in
    ``_route``) and ``warm_traces`` — run only on the serving layer's
    background thread, which swallows errors — replays what the
    reference's does."""
    batches = synthesize_churn_stream(N, 3, ADDS, seed=SEED, delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    port_g = TSharded(SHARDS, N, e_max, device="cpu")
    ref_g = RSharded(SHARDS, N, e_max)
    for b in batches:
        port_g.apply(b)
        ref_g.apply(b)
    v = batches[-1].version
    tv = TV(v.epoch, v.number)
    hot = np.arange(0, N, 3)
    routed = tq.RoutedSnapshot(port_g.build_replica_plan(tv, hot),
                               port_g.shard_views(tv))
    view = port_g.join_view(tv)
    engine = tq.SnapshotQueryEngine()
    sub = engine._route(routed, view, np.array([1, 2], np.int32), 2)
    assert isinstance(sub.src, torch.Tensor) and sub.src.dtype == torch.int32
    assert sub.m == sub.src.numel() and sub.m & (sub.m - 1) == 0

    from repro.graph.query import KHop, Reachability, SnapshotQueryEngine
    ref_engine = SnapshotQueryEngine()
    rview = ref_g.join_view(v)
    window = [KHop(1, 2), KHop(4, 2), Reachability(0, 9, max_hops=3)]
    engine.execute(view, [port_query(q) for q in window])
    ref_engine.execute(rview, window)
    assert engine.warm_traces(view) == ref_engine.warm_traces(rview) > 0
    assert engine.warm_traces(view) == 0       # replayed once per width
