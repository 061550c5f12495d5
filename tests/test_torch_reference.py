"""The port's loop oracle (``graph/reference.py``) against the JAX
package's, and the port's vectorized store against its loop oracle: the
same churn stream applied to both loop stores leaves byte-identical
tables and CSRs, and the port's ``DynamicGraph`` join views equal its
oracle's CSRs at every version, by full rebuild and by delta patch."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import assert_same  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph.dyngraph import synthesize_churn_stream  # noqa: E402
from repro.graph.reference import LoopDynamicGraph as RLoop  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph.dyngraph import DynamicGraph, MutationBatch  # noqa: E402
from repro_torch.graph.reference import LoopDynamicGraph as TLoop  # noqa: E402

TABLES = ("src", "dst", "created", "deleted", "v_created", "v_type")


def _port_batch(b):
    """The port's MutationBatch equal to a reference batch."""
    return MutationBatch(TV(b.version.epoch, b.version.number),
                         add_src=b.add_src, add_dst=b.add_dst,
                         del_src=b.del_src, del_dst=b.del_dst,
                         add_vertices=b.add_vertices,
                         vertex_types=b.vertex_types)


def _stream(delete_frac, readd_frac, n=32, epochs=6, adds=50):
    return synthesize_churn_stream(n, epochs, adds, seed=11,
                                   delete_frac=delete_frac,
                                   readd_frac=readd_frac), n, epochs


@pytest.mark.parametrize("delete_frac,readd_frac",
                         [(0.0, 0.0), (0.4, 0.0), (0.3, 0.5)])
def test_loop_oracle_tables_and_csr_equal_reference(delete_frac, readd_frac):
    batches, n, epochs = _stream(delete_frac, readd_frac)
    ref, port = RLoop(n, 4096), TLoop(n, 4096)
    for b in batches:
        ref.apply(b)
        port.apply(_port_batch(b))
        assert_same(port.snapshot_mask(TV(b.version.epoch, 0)),
                    ref.snapshot_mask(b.version), "mask")
    for f in TABLES:
        assert_same(getattr(port, f), getattr(ref, f), f)
    assert (port.n_edges, port.n_vertices) == (ref.n_edges, ref.n_vertices)
    assert [v.pack() for v in port.versions] == \
        [v.pack() for v in ref.versions]
    for e in range(epochs):
        for got, want in zip(port.join_view_arrays(TV(e, 0)),
                             ref.join_view_arrays(RV(e, 0))):
            assert_same(got, want, f"csr @{e}")


@pytest.mark.parametrize("delete_frac,readd_frac,churn",
                         [(0.0, 0.0, 0.25), (0.4, 0.0, 0.25),
                          (0.3, 0.5, 10.0)])
def test_port_views_equal_loop_oracle(delete_frac, readd_frac, churn):
    """A churn threshold of 10 forces the delta patch at every epoch."""
    batches, n, epochs = _stream(delete_frac, readd_frac)
    g = DynamicGraph(n, 4096, churn_threshold=churn, device="cpu")
    oracle = TLoop(n, 4096)
    for b in batches:
        pb = _port_batch(b)
        g.apply(pb)
        oracle.apply(pb)
        assert_same(g.snapshot_mask(pb.version),
                    oracle.snapshot_mask(pb.version), "mask")
        g.join_view(pb.version)
    for e in range(epochs):
        view = g.join_view(TV(e, 0))
        offsets, src, dst, out_deg, in_deg = oracle.join_view_arrays(TV(e, 0))
        assert_same(view.offsets, offsets.astype(np.int32), "offsets")
        assert_same(view.src, src, "src")
        assert_same(view.dst, dst, "dst")
        assert_same(view.out_degree, out_deg.astype(np.float32), "out")
        assert_same(view.in_degree, in_deg.astype(np.float32), "in")
    assert g.n_vertices == oracle.n_vertices
    assert_same(g.v_created, oracle.v_created, "v_created")
    if churn > 1:
        assert g.view_delta_patches > 0


def test_loop_oracle_errors_equal_reference():
    batches, n, _ = _stream(0.2, 0.0)
    msgs = []
    for loop, conv in ((RLoop, lambda b: b), (TLoop, _port_batch)):
        g = loop(n, 60)
        g.apply(conv(batches[0]))
        with pytest.raises(ValueError) as older:
            g.apply(conv(batches[0]))
        with pytest.raises(MemoryError) as full:
            g.apply(conv(batches[1]))
        msgs.append((str(older.value), str(full.value)))
    assert msgs[0] == msgs[1]
