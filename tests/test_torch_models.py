"""The port's programming models (Pregel, edge-centric, MapReduce on the
protocol-dataflow runtime) against the JAX package's: on the same
snapshot they compute on the host in float64 with the same operations in
the same order, so their results are byte-identical; and they agree with
the port's own ``compute.pagerank`` within the reference's tolerances
(``tests/test_graph.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import models as rm  # noqa: E402
from repro.graph.dyngraph import synthesize_stream as r_stream  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import compute as tgc  # noqa: E402
from repro_torch.graph import models as tm  # noqa: E402
from repro_torch.graph.dyngraph import synthesize_stream as t_stream  # noqa: E402


def _views(seed, n=24, epochs=3, adds=30):
    rg, _ = r_stream(n, epochs, adds, seed=seed)
    tg, _ = t_stream(n, epochs, adds, seed=seed, device="cpu")
    return (rg.join_view(RV(epochs - 1, 0)),
            tg.join_view(TV(epochs - 1, 0)))


@pytest.mark.parametrize("n_parts", [1, 3, 4])
def test_pregel_byte_identical_to_reference(n_parts):
    rv, tv = _views(6)
    want = rm.run_pregel(rv, rm.pagerank_program(n=rv.n), n_parts=n_parts,
                         init_value=1.0 / rv.n, supersteps=60)
    got = tm.run_pregel(tv, tm.pagerank_program(n=tv.n), n_parts=n_parts,
                        init_value=1.0 / tv.n, supersteps=60)
    assert_same(got, want, f"pregel P={n_parts}")


@pytest.mark.parametrize("n_parts,iters", [(1, 5), (4, 40), (7, 13)])
def test_edge_centric_byte_identical_to_reference(n_parts, iters):
    rv, tv = _views(7)
    want = rm.run_edge_centric(rv, n_parts=n_parts, iters=iters)
    got = tm.run_edge_centric(tv, n_parts=n_parts, iters=iters)
    assert_same(got, want, f"edge-centric P={n_parts}")


@pytest.mark.parametrize("n_reducers", [1, 4])
def test_mapreduce_equals_reference(n_reducers):
    records = ["a b a", "b c", "a", "d d d c"]

    def words(line):
        return [(w, 1) for w in line.split()]

    def total(k, vs):
        return sum(vs)
    got = tm.run_mapreduce(records, map_fn=words, reduce_fn=total,
                           n_reducers=n_reducers)
    want = rm.run_mapreduce(records, map_fn=words, reduce_fn=total,
                            n_reducers=n_reducers)
    assert got == want == {"a": 3, "b": 2, "c": 2, "d": 3}


def test_pregel_pagerank_matches_port_oracle():
    _, view = _views(6)
    ref = tgc.pagerank(view, tol=1e-12, max_iter=60, handle_dangling=False)
    got = tm.run_pregel(view, tm.pagerank_program(n=view.n), n_parts=3,
                        init_value=1.0 / view.n, supersteps=60)
    np.testing.assert_allclose(got, ref.ranks.numpy(), atol=1e-4)


def test_edge_centric_pagerank_matches_port_oracle():
    _, view = _views(7)
    ref = tgc.pagerank(view, tol=1e-12, max_iter=40, handle_dangling=False)
    got = tm.run_edge_centric(view, n_parts=4, iters=40)
    np.testing.assert_allclose(got, ref.ranks.numpy(), atol=1e-5)


def test_pregel_partition_and_protocol_events():
    """A partition holds its src range's out-edges as host arrays with the
    view's dtypes; the Pregel protocol orders one partition's supersteps."""
    _, view = _views(6)
    part = tm.PregelPartition("p1", 1, 3, view, tm.pagerank_program(n=view.n),
                              0.0, 8)
    src = view.src.numpy()
    assert part.out_src.dtype == np.int32
    assert_same(part.out_src, src[(src >= 8) & (src < 16)], "out_src")
    ev = [tm.PREGEL.happens_before(
        type("E", (), {"kind": "superstep", "payload": {"part": p, "step": s}}),
        type("E", (), {"kind": "superstep", "payload": {"part": 0, "step": 2}}))
        for p, s in ((0, 1), (0, 3), (1, 1))]
    assert ev == [True, None, None]
