"""Port graph compute (``repro_torch.graph.compute``) against the JAX
reference on the same snapshots: the frontier queries, top-k, WCC and SSSP
byte-identical; PageRank within atol 1e-6 with iteration counts within one
(float32 sums taken in another order move the residual test by one step
at most)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import assert_same  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import compute as rc  # noqa: E402
from repro.graph import dyngraph as rd  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import compute as tc  # noqa: E402
from repro_torch.graph import dyngraph as td  # noqa: E402

N, EPOCHS = 40, 5


@pytest.fixture(scope="module")
def graphs():
    g, _ = td.synthesize_stream(N, EPOCHS, 45, seed=21, delete_frac=0.2,
                                device="cpu")
    gr, _ = rd.synthesize_stream(N, EPOCHS, 45, seed=21, delete_frac=0.2)
    return g, gr


def _views(graphs, epoch):
    g, gr = graphs
    return g.join_view(TV(epoch, 0)), gr.join_view(RV(epoch, 0))


@pytest.mark.parametrize("epoch", [0, EPOCHS - 1])
def test_batched_frontiers_byte_identical(graphs, epoch):
    view, rview = _views(graphs, epoch)
    rng = np.random.default_rng(epoch)
    for s in (1, 5, 8):
        src = rng.integers(0, N, s).astype(np.int32)
        dst = rng.integers(0, N, s).astype(np.int32)
        for k in (1, 2, 3):
            assert_same(tc.batched_k_hop(view, src, k),
                        rc.batched_k_hop(rview, src, k), f"k_hop s={s}")
        for hops in (None, 0, 2):
            assert_same(tc.batched_reachability(view, src, dst, hops),
                        rc.batched_reachability(rview, src, dst, hops),
                        f"reach s={s} hops={hops}")
    for pad in (False, True):
        assert_same(tc.batched_k_hop(view, [3, 7], 2, pad_sources=pad,
                                     pad_edges=pad),
                    rc.batched_k_hop(rview, np.array([3, 7], np.int32), 2,
                                     pad_sources=pad, pad_edges=pad))
    assert_same(tc.batched_k_hop(view, np.zeros(0, np.int32), 2),
                rc.batched_k_hop(rview, np.zeros(0, np.int32), 2))


def test_scalar_queries_match(graphs):
    view, rview = _views(graphs, EPOCHS - 1)
    assert_same(tc.k_hop(view, np.array([0, 5]), 2),
                rc.k_hop(rview, jnp.array([0, 5]), 2))
    for s, d, h in [(0, 39, None), (3, 3, 2), (1, 20, 1), (7, 30, 4)]:
        assert tc.reachability(view, s, d, h) \
            == rc.reachability(rview, s, d, h)


@pytest.mark.parametrize("direction", ["in", "out"])
def test_degree_topk_ties_go_to_lowest_id(graphs, direction):
    view, rview = _views(graphs, 2)
    for k in (1, 5, 17, N + 10):
        ids, vals = tc.degree_topk(view, k, direction=direction)
        rids, rvals = rc.degree_topk(rview, k, direction=direction)
        assert_same(ids, rids, f"ids k={k}")
        assert_same(vals, rvals, f"degrees k={k}")
    # ties really occur at this size, so the order among them was tested
    deg = view.in_degree if direction == "in" else view.out_degree
    assert len(torch.unique(deg)) < N


def test_wcc_and_sssp_byte_identical(graphs):
    view, rview = _views(graphs, EPOCHS - 1)
    assert_same(tc.wcc(view), rc.wcc(rview))
    for frac in (0.0, 0.5):
        got = tc.sssp(view, 0, priority_fraction=frac)
        want = rc.sssp(rview, 0, priority_fraction=frac)
        assert_same(got.dist, want.dist, f"sssp dist frac={frac}")
        assert (got.rounds, got.relaxations) \
            == (want.rounds, want.relaxations)


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_join_group_by_matches(graphs, reduce):
    view, rview = _views(graphs, 3)
    vals = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    got = tc.join_group_by(view, torch.from_numpy(vals), reduce=reduce)
    want = rc.join_group_by(rview, jnp.asarray(vals), reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert got.dtype == torch.float32


def test_pagerank_and_incremental_within_tolerance(graphs):
    prev, rprev = _views(graphs, EPOCHS - 2)
    view, rview = _views(graphs, EPOCHS - 1)
    for kw in (dict(tol=1e-6), dict(tol=1e-7, max_iter=300),
               dict(handle_dangling=False)):
        got = tc.pagerank(prev, **kw)
        want = rc.pagerank(rprev, **kw)
        assert got.ranks.dtype == torch.float32
        np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                                   rtol=0, atol=1e-6)
        assert abs(got.iterations - want.iterations) <= 1
        assert isinstance(got.iterations, int)
        assert isinstance(got.residual, float)
        inc = tc.incremental_pagerank(got, prev, view, **kw)
        rinc = rc.incremental_pagerank(want, rprev, rview, **kw)
        np.testing.assert_allclose(inc.ranks.numpy(), np.asarray(rinc.ranks),
                                   rtol=0, atol=1e-6)
        assert abs(inc.iterations - rinc.iterations) <= 1


def test_timelines_and_emerging_vertices(graphs):
    g, gr = graphs
    versions = [(e, 0) for e in range(EPOCHS)]
    assert_same(tc.degree_timeline(g, [TV(*v) for v in versions]),
                rc.degree_timeline(gr, [RV(*v) for v in versions]))
    got = tc.pagerank_timeline(g, [TV(*v) for v in versions], tol=1e-7)
    want = rc.pagerank_timeline(gr, [RV(*v) for v in versions], tol=1e-7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.ranks.numpy(), np.asarray(b.ranks),
                                   rtol=0, atol=1e-6)
        assert abs(a.iterations - b.iterations) <= 1
    assert_same(tc.emerging_vertices(g, TV(1, 0), TV(4, 0), top_k=5),
                rc.emerging_vertices(gr, RV(1, 0), RV(4, 0), top_k=5))
