"""Port dynamic graph store (``repro_torch.graph.dyngraph``) against the
JAX reference: the same seed gives the same synthetic batches, and the
same batches give byte-identical snapshot masks and join views at every
version, by delta patch and by full rebuild, with the reference's dtypes.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import assert_same, assert_views_same  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import dyngraph as rd  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import dyngraph as td  # noqa: E402

FIELDS = ("add_src", "add_dst", "del_src", "del_dst", "add_vertices",
          "vertex_types")


def _assert_batches_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert (a.version.epoch, a.version.number) \
            == (b.version.epoch, b.version.number)
        for f in FIELDS:
            assert_same(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("delete_frac,readd_frac", [(0.0, 0.0), (0.2, 0.0),
                                                    (0.3, 0.5)])
def test_churn_stream_equals_reference(delete_frac, readd_frac):
    kw = dict(seed=11, delete_frac=delete_frac, readd_frac=readd_frac)
    _assert_batches_equal(td.synthesize_churn_stream(40, 6, 50, **kw),
                          rd.synthesize_churn_stream(40, 6, 50, **kw))


def test_skewed_stream_equals_reference():
    kw = dict(seed=3, zipf_a=1.3, delete_frac=0.25)
    _assert_batches_equal(td.synthesize_skewed_stream(64, 5, 40, **kw),
                          rd.synthesize_skewed_stream(64, 5, 40, **kw))


def test_synthesize_stream_equals_reference_and_views_match():
    g, port = td.synthesize_stream(60, 6, 40, seed=2, delete_frac=0.2,
                                   device="cpu")
    gr, ref = rd.synthesize_stream(60, 6, 40, seed=2, delete_frac=0.2)
    _assert_batches_equal(port, ref)
    assert_same(g.v_created, gr.v_created)
    assert_same(g.v_type, gr.v_type)
    for e in range(6):
        assert_views_same(g.join_view(TV(e, 0)), gr.join_view(RV(e, 0)),
                          f"epoch {e}")


def _both(n, e_max, **kw):
    return (td.DynamicGraph(n, e_max, device="cpu", **kw),
            rd.DynamicGraph(n, e_max, **kw))


@pytest.mark.parametrize("delete_frac", [0.0, 0.3])
def test_views_byte_identical_by_delta_patch_and_full_rebuild(delete_frac):
    n, epochs = 48, 8
    batches = rd.synthesize_churn_stream(n, epochs, 40, seed=5,
                                         delete_frac=delete_frac,
                                         readd_frac=0.25)
    # a high churn threshold forces the delta patch on every epoch; the
    # cold stores rebuild every view from the mask
    warm, warm_ref = _both(n, 4096, churn_threshold=10.0)
    cold, cold_ref = _both(n, 4096)
    for b in batches:
        for g in (warm, warm_ref, cold, cold_ref):
            g.apply(b)
        v = b.version
        assert_views_same(warm.join_view(TV(v.epoch, v.number)),
                          warm_ref.join_view(v), f"delta {v}")
    assert warm.view_delta_patches > 0
    assert warm.view_delta_patches == warm_ref.view_delta_patches
    for e in range(epochs):
        assert_views_same(cold._full_rebuild(TV(e, 0)),
                          cold_ref._full_rebuild(RV(e, 0)), f"full {e}")
        assert_views_same(warm._views[TV(e, 0).pack()],
                          cold_ref._full_rebuild(RV(e, 0)), f"warm {e}")


def test_join_view_dtypes_are_the_references():
    g, _ = td.synthesize_stream(20, 2, 10, seed=1, device="cpu")
    view = g.join_view(TV(1, 0))
    assert view.offsets.dtype == torch.int32
    assert view.src.dtype == torch.int32 and view.dst.dtype == torch.int32
    assert view.out_degree.dtype == torch.float32
    assert view.in_degree.dtype == torch.float32
    assert view.offsets.shape == (21,)


def test_snapshot_mask_matches_reference_with_clamped_queries():
    batches = rd.synthesize_churn_stream(30, 5, 40, seed=9, delete_frac=0.4)
    g, gr = _both(30, 1024)
    empty_port, empty_ref = g.snapshot_mask(TV(0, 0)), gr.snapshot_mask(
        RV(0, 0))
    assert_same(empty_port, empty_ref, "zero edges")
    for b in batches:
        g.apply(b)
        gr.apply(b)
    for v in [(0, 0), (2, 0), (2, 1 << 25), (1 << 30, 0), (1 << 30, 1 << 30)]:
        assert_same(g.snapshot_mask(TV(*v)), gr.snapshot_mask(RV(*v)),
                    f"mask at {v}")
        assert_same(g.snapshot_mask(TV(*v), use_kernel=False),
                    gr.snapshot_mask(RV(*v)), f"plain mask at {v}")


def test_stamp_mirrors_follow_apply_and_resync():
    batches = rd.synthesize_churn_stream(30, 4, 40, seed=4, delete_frac=0.5)
    g = td.DynamicGraph(30, 512, device="cpu")
    for b in batches:
        g.apply(b)
        assert_same(g._d_created, g.created)
        assert_same(g._d_deleted, g.deleted)
    # a wholesale stamp write (as a checkpoint restore does) is picked up
    # only after sync_stamp_mirrors
    g.deleted[:g.n_edges] = td.MAXV
    assert not np.array_equal(g._d_deleted.numpy(), g.deleted)
    g.sync_stamp_mirrors()
    assert_same(g._d_deleted, g.deleted)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        td.DynamicGraph(4, 4)
