"""The port's graph demos against the JAX package's examples, on the CPU.

``examples/torch_dynamic_graph_end_to_end.py`` prints the reference
demo's lines (its PageRank iteration counts aside: see the test);
``examples/torch_serve_graph_live.py`` and
``examples/torch_rpc_quickstart.py`` serve answers that equal, byte for
byte, the reference's single-store replay of the same stream at the
version each was served from. Both packages run on the same seeds.
"""
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same, both_streams, host,  # noqa: E402
                           load_chip_smoke)

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import compute as rgc  # noqa: E402
from repro.graph import query as rq  # noqa: E402
from repro.graph.dyngraph import DynamicGraph as RGraph  # noqa: E402
from repro.graph.dyngraph import synthesize_stream as rstream  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import compute as tgc  # noqa: E402
from repro_torch.graph.dyngraph import \
    synthesize_stream as tstream  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TIMELINE = "  pagerank timeline: iters/epoch = "
# the port's PageRank iteration counts in the demo against the reference's
ITERATIONS_RTOL = 0.25


def _stdout_of(path, argv, capsys) -> list[str]:
    capsys.readouterr()
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return capsys.readouterr().out.splitlines()


def _timeline(line: str) -> tuple[list[int], int]:
    """The iteration counts of a ``pagerank timeline`` line: per version,
    and the cold run's on the last."""
    m = re.fullmatch(re.escape(TIMELINE) + r"\[([\d, ]+)\] "
                     r"\(cold last-epoch: (\d+)\)", line)
    assert m, line
    return [int(x) for x in m.group(1).split(",")], int(m.group(2))


def test_end_to_end_demo_prints_the_reference_lines(capsys):
    """The port's end-to-end demo at the reference's size (256 vertices,
    8 epochs of 300 adds, 4 shards) prints the reference demo's stdout
    line for line — schema, straggler frontier, dispatch, edges per
    shard, the stitched view, 2-hop and reachability, emerging vertices,
    WCC, hit rates, comm bytes, partitions, the top-10 — except the
    PageRank iteration counts at tol 1e-8, the float32 rounding floor:
    XLA compiles the reference's update with another rounding than its
    op-by-op dispatch, which the port's iteration equals bit for bit
    (:func:`test_pagerank_iteration_rounds_as_the_reference_op_by_op`),
    so the counts of the two packages differ there by a few. That line
    is held to the reference's counts within ITERATIONS_RTOL, and on the
    last version, where the timeline's warm start and the cold run see
    the same graph, the warm count under the cold one in both packages
    (the earlier versions' warm counts are of other graphs: the
    reference's run 41 on the second against 19 cold on the last); and
    each package's run to convergence (below tol, under max_iter)."""
    want = _stdout_of(EXAMPLES / "dynamic_graph_end_to_end.py", [], capsys)
    got = _stdout_of(EXAMPLES / "torch_dynamic_graph_end_to_end.py",
                     ["--device", "cpu"], capsys)
    assert len(got) == len(want)
    timeline = [i for i, line in enumerate(want) if line.startswith(TIMELINE)]
    assert len(timeline) == 1
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if i != timeline[0]:
            assert g == w, f"line {i}"
    (warm_p, cold_p), (warm_r, cold_r) = (_timeline(x[timeline[0]])
                                          for x in (got, want))
    assert len(warm_p) == len(warm_r) == 8
    for p, r in zip(warm_p + [cold_p], warm_r + [cold_r], strict=True):
        assert abs(p - r) <= ITERATIONS_RTOL * r, (warm_p, cold_p, warm_r,
                                                   cold_r)
    assert warm_p[-1] < cold_p and warm_r[-1] < cold_r
    g, batches = rstream(256, 8, 300, seed=42)
    t, tb = tstream(256, 8, 300, seed=42, device="cpu")
    versions = list(range(8))
    ref = rgc.pagerank_timeline(g, [RV(e, 0) for e in versions], tol=1e-8,
                                max_iter=300)
    port = tgc.pagerank_timeline(t, [TV(e, 0) for e in versions], tol=1e-8,
                                 max_iter=300)
    for r, p in zip(ref, port, strict=True):
        assert r.residual <= 1e-8 and r.iterations < 300
        assert p.residual <= 1e-8 and p.iterations < 300
        np.testing.assert_allclose(host(p.ranks), np.asarray(r.ranks),
                                   rtol=0, atol=1e-6)


def test_pagerank_iteration_rounds_as_the_reference_op_by_op():
    """Why the demo's PageRank iteration counts differ: on each of the
    demo's 8 versions, one iteration of the port's PageRank equals, bit
    for bit, the reference's update (``graph/compute.py:72-82``)
    dispatched op by op, while the reference's own first iteration, that
    update compiled as its ``while_loop`` body, differs from both in some
    ranks (248 of 256 on the first version). At tol 1e-8 these last-bit
    differences move the iteration at which the residual crosses tol."""
    import jax.numpy as jnp

    g, _ = rstream(256, 8, 300, seed=42)
    t, _ = tstream(256, 8, 300, seed=42, device="cpu")
    damping, differ = 0.85, []
    for e in range(8):
        view = g.join_view(RV(e, 0))
        n = view.n
        pr = jnp.full((n,), 1.0 / n)
        agg = rgc.join_group_by(view, pr / jnp.maximum(view.out_degree, 1.0))
        agg = agg + jnp.sum(jnp.where(view.out_degree == 0, pr, 0.0)) / n
        op_by_op = np.asarray((1.0 - damping) / n + damping * agg)
        loop = np.asarray(rgc.pagerank(view, tol=1e-8, max_iter=1).ranks)
        port = host(tgc.pagerank(t.join_view(TV(e, 0)), tol=1e-8,
                                 max_iter=1).ranks)
        assert_same(port, op_by_op, f"version {e}")
        differ.append(int((loop != op_by_op).sum()))
    assert differ[0] == 248 and all(d > 0 for d in differ), differ


def _ref_query(q):
    return getattr(rq, type(q).__name__)(**q.__dict__)


def _replay_same(batches, n, answers) -> dict:
    """Every non-PageRank answer ((query, version, value) triples of the
    port) equal, byte for byte, to the reference's single-store replay of
    ``batches`` at the answer's version; returns the counts by kind."""
    e_max = sum(len(b.add_src) for b in batches) + 16
    g = RGraph(n, e_max)
    for b in batches:
        g.apply(b)
    engine = rq.SnapshotQueryEngine(result_cache=False)
    by_version = {}
    for q, version, value in answers:
        if type(q).__name__ != "PageRankQuery":
            by_version.setdefault((version.epoch, version.number),
                                  []).append((q, value))
    counts = {}
    for (e, num), qvs in sorted(by_version.items()):
        want = engine.execute(g.join_view(RV(e, num)),
                              [_ref_query(q) for q, _ in qvs])
        for (q, value), w in zip(qvs, want, strict=True):
            kind = type(q).__name__
            if isinstance(w, tuple):
                assert len(value) == len(w)
                for a, b in zip(value, w):
                    assert_same(a, b, f"{q} at {e}")
            elif kind == "Reachability":
                assert bool(value) == bool(w), f"{q} at {e}"
            else:
                assert_same(value, w, f"{q} at {e}")
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def test_live_demo_answers_equal_the_reference_replay():
    """The port's live demo at the reference's ``--smoke`` size (300
    vertices, 6 epochs of 150 adds, ingest paced 0.8 s, prewarm on):
    every k-hop, reachability and top-k answer equals the reference's
    single-store replay at its served version, byte for byte; the stream
    is the reference's; the prewarm thread ran."""
    demo = load_chip_smoke().load_demo("torch_serve_graph_live")
    run = demo.SMOKE
    f = demo.run_demo(run, "cpu")
    tb, rb = both_streams("synthesize_churn_stream", run.vertices,
                          run.epochs, run.adds, seed=run.seed,
                          delete_frac=0.2)
    counts = _replay_same(rb, run.vertices,
                          [(r.query, r.version, r.value)
                           for r in f["answered"]])
    assert counts == f["audited"]
    assert all(counts[k] > 0 for k in ("KHop", "Reachability",
                                       "DegreeTopK"))
    assert f["final_epoch"] == run.epochs - 1 and f["prewarm_runs"] > 0


def test_live_demo_audit_catches_a_wrong_answer():
    """The demo's own audit fails on one altered k-hop answer."""
    demo = load_chip_smoke().load_demo("torch_serve_graph_live")
    run = demo.SMOKE
    from repro_torch.graph.dyngraph import DynamicGraph
    from repro_torch.graph.query import KHop

    tb, _ = both_streams("synthesize_churn_stream", run.vertices, 2,
                         run.adds, seed=run.seed, delete_frac=0.2)
    g = DynamicGraph(run.vertices, 4 * run.adds, device="cpu")
    for b in tb:
        g.apply(b)
    q = KHop(3, k=2)
    good = tgc.k_hop(g.join_view(TV(1, 0)), np.array([3]), 2)
    assert demo.audit(run.vertices, tb, [(q, TV(1, 0), good)]) \
        == {"KHop": 1}
    bad = good.clone()
    bad[0] = ~bad[0]
    with pytest.raises(RuntimeError, match="divergence"):
        demo.audit(run.vertices, tb, [(q, TV(1, 0), bad)])


def test_rpc_quickstart_answers_equal_the_reference_replay():
    """The port's RPC quickstart at the reference's sizes: the server is
    the port's ``serve_graph`` subprocess on the CPU; every client's
    pinned replay is byte-identical, and every answer equals the
    reference's single-store replay of the server's stream at its
    version."""
    demo = load_chip_smoke().load_demo("torch_rpc_quickstart")
    run = demo.RpcRun()
    f = demo.run_demo(run, "cpu")
    assert f["returncode"] == 0
    assert f["pinned"] == run.clients
    assert sum(f["audited"].values()) == len(f["answers"]) \
        == run.clients * run.queries_per_client
    _, rb = both_streams("synthesize_churn_stream", run.vertices,
                         run.epochs, run.adds, seed=run.seed,
                         delete_frac=0.2)
    assert _replay_same(rb, run.vertices, f["answers"]) == f["audited"]
