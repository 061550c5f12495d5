"""The port's partitioned join-group-by (``graph/partition.py``) against
the JAX package's: byte-identical partition arrays (hubs included) from
both builders and both placements, the same ``comm_model`` and the same
``ValueError``s, and all three modes of ``distributed_join_group_by``
within rtol 1e-6 of the reference on one partition (in this process) and
on four (the reference on a 4-device host mesh in a subprocess). Also the
CPU rehearsal of ``chip_smoke.py``'s phase 6, planted faults included."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import assert_same  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import dyngraph as rdg  # noqa: E402
from repro.graph import partition as rp  # noqa: E402
from repro.graph.sharded import ShardedDynamicGraph as RSharded  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import compute as tgc  # noqa: E402
from repro_torch.graph import dyngraph as tdg  # noqa: E402
from repro_torch.graph import partition as tp  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("allgather", "scatter", "hub")
FIELDS = ("src", "dst", "mask", "out_degree", "hubs", "is_hub")


def _views(n=64, epochs=3, adds=120, seed=8):
    rg, _ = rdg.synthesize_stream(n, epochs, adds, seed=seed)
    tg, _ = tdg.synthesize_stream(n, epochs, adds, seed=seed, device="cpu")
    return (rg.join_view(RV(epochs - 1, 0)),
            tg.join_view(TV(epochs - 1, 0)))


def _shard_views(n_shards=4, n=48, epochs=5, adds=60, seed=9):
    views = []
    for stream, sharded, version, kw in (
            (rdg.synthesize_churn_stream, RSharded, RV, {}),
            (tdg.synthesize_churn_stream, TSharded, TV, {"device": "cpu"})):
        sg = sharded(n_shards, n, 4096, **kw)
        for b in stream(n, epochs, adds, seed=seed, delete_frac=0.2):
            sg.apply(b)
        v = version(epochs - 1, 0)
        views.append((sg.shard_views(v), sg.join_view(v)))
        sg.shutdown()
    return views


def _assert_pg_same(got, want, what):
    assert (got.n, got.n_parts, got.placement, got.n_local) == \
        (want.n, want.n_parts, want.placement, want.n_local)
    for f in FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f"{what} {f}")


def _values(n):
    return np.random.default_rng(3).random(n).astype(np.float32)


@pytest.mark.parametrize("n_parts,hub_k,pad_to",
                         [(1, 4, None), (4, 4, None), (8, 0, None),
                          (3, 5, 200)])
def test_partition_graph_byte_identical(n_parts, hub_k, pad_to):
    rv, tv = _views()
    _assert_pg_same(tp.partition_graph(tv, n_parts, hub_k=hub_k,
                                       pad_to=pad_to),
                    rp.partition_graph(rv, n_parts, hub_k=hub_k,
                                       pad_to=pad_to), "graph")


@pytest.mark.parametrize("placement", ["dst_hash", "src"])
def test_partition_graph_sharded_byte_identical(placement):
    (rviews, _), (tviews, _) = _shard_views()
    _assert_pg_same(
        tp.partition_graph_sharded(tviews, hub_k=6, placement=placement),
        rp.partition_graph_sharded(rviews, hub_k=6, placement=placement),
        placement)


def test_hubs_keep_numpy_tie_order():
    """Equal out-degrees: the hubs are ``np.argsort``'s pick, not a
    device sort's."""
    rv, tv = _views()
    deg = np.asarray(rv.out_degree)
    k = 12
    assert len(np.unique(deg[np.argsort(-deg)[:k + 4]])) < k + 4  # ties
    assert_same(tp.partition_graph(tv, 4, hub_k=k).hubs,
                rp.partition_graph(rv, 4, hub_k=k).hubs, "hubs")


@pytest.mark.parametrize("n_parts,hub_k", [(1, 0), (8, 4), (16, 8)])
def test_comm_model_equals_reference(n_parts, hub_k):
    rv, tv = _views()
    got = tp.comm_model(tp.partition_graph(tv, n_parts, hub_k=hub_k))
    want = rp.comm_model(rp.partition_graph(rv, n_parts, hub_k=hub_k))
    assert got == want
    if hub_k:
        assert got["hub"] < got["allgather"]


def test_value_errors_equal_reference():
    (rviews, _), (tviews, _) = _shard_views()
    cases = [lambda m, views: m.partition_graph_sharded([]),
             lambda m, views: m.partition_graph_sharded(views,
                                                        placement="dst"),
             lambda m, views: m.partition_graph_sharded(views, pad_to=1),
             lambda m, views: m.partition_graph_sharded(views, pad_to=1,
                                                        placement="src")]
    msgs = []
    for m, views in ((rp, rviews), (tp, tviews)):
        out = []
        for case in cases:
            with pytest.raises(ValueError) as exc:
                case(m, views)
            out.append(str(exc.value))
        msgs.append(out)
    assert msgs[0] == msgs[1]
    mesh = jax.make_mesh((1,), ("data",))
    for mode in ("scatter", "hub", "ring"):
        errs = []
        for m, views, call in (
                (rp, rviews, lambda pg, v: rp.distributed_join_group_by(
                    pg, jnp.asarray(v), mesh, mode=mode)),
                (tp, tviews, lambda pg, v: tp.distributed_join_group_by(
                    pg, torch.from_numpy(v), mode=mode))):
            pg = m.partition_graph_sharded(views[:1])
            with pytest.raises(ValueError) as exc:
                call(pg, _values(pg.n))
            errs.append(str(exc.value))
        assert errs[0] == errs[1], mode


@pytest.mark.parametrize("mode", MODES)
def test_distributed_join_group_by_matches_reference_p1(mode):
    rv, tv = _views(32, 3, 60)
    rpg, tpg = (rp.partition_graph(rv, 1, hub_k=4),
                tp.partition_graph(tv, 1, hub_k=4))
    vals = _values(rpg.n)
    mesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(rp.distributed_join_group_by(rpg, jnp.asarray(vals),
                                                   mesh, mode=mode))
    got = tp.distributed_join_group_by(tpg, torch.from_numpy(vals),
                                       mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy()[:tv.n],
        tgc.join_group_by(tv, torch.from_numpy(vals[:tv.n])).numpy(),
        rtol=1e-6)


# The reference on a 4-device host mesh, run under jax.set_mesh (outside
# a mesh context its shard_map gather fails to lower on four devices).
_P4_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core.versioned import Version
from repro.graph import dyngraph as dg
from repro.graph import partition as gp
from repro.graph.sharded import ShardedDynamicGraph

assert len(jax.devices()) == 4, jax.devices()
mesh = jax.make_mesh((4,), ("data",))
g, _ = dg.synthesize_stream(64, 3, 120, seed=8)
pgs = {"graph": gp.partition_graph(g.join_view(Version(2, 0)), 4, hub_k=4)}
sg = ShardedDynamicGraph(4, 48, 4096)
for b in dg.synthesize_churn_stream(48, 5, 60, seed=9, delete_frac=0.2):
    sg.apply(b)
views = sg.shard_views(Version(4, 0))
for placement in ("dst_hash", "src"):
    pgs[placement] = gp.partition_graph_sharded(views, hub_k=6,
                                                placement=placement)
out = {}
with jax.set_mesh(mesh):
    for name, pg in pgs.items():
        vals = np.random.default_rng(3).random(pg.n).astype(np.float32)
        modes = ("allgather",) if name == "dst_hash" else (
            "allgather", "scatter", "hub")
        for mode in modes:
            out[f"{name}/{mode}"] = np.asarray(gp.distributed_join_group_by(
                pg, jnp.asarray(vals), mesh, mode=mode))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_p4(tmp_path_factory):
    path = tmp_path_factory.mktemp("p4") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _P4_SCRIPT, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", [
    "graph/allgather", "graph/scatter", "graph/hub", "dst_hash/allgather",
    "src/allgather", "src/scatter", "src/hub"])
def test_distributed_join_group_by_matches_reference_p4(case, reference_p4):
    name, mode = case.split("/")
    if name == "graph":
        _, tv = _views()
        pg = tp.partition_graph(tv, 4, hub_k=4)
    else:
        _, (tviews, _) = _shard_views()
        pg = tp.partition_graph_sharded(tviews, hub_k=6, placement=name)
    vals = _values(pg.n)
    got = tp.distributed_join_group_by(pg, torch.from_numpy(vals), mode=mode)
    want = reference_p4[case]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_mode_values_replicate_the_reference_collectives():
    """Row p of the scatter values is partition p's slice; the hub mode
    mirrors each hub's value into every row; non-finite values propagate
    through the mask's multiply as they do in the reference."""
    _, tv = _views()
    pg = tp.partition_graph(tv, 4, hub_k=4)
    vals = torch.from_numpy(_values(pg.n))
    nl = pg.n_local
    scat = tp.mode_values(pg, vals, "scatter")
    for p in range(4):
        assert torch.equal(scat[p, p * nl:(p + 1) * nl],
                           vals[p * nl:(p + 1) * nl])
        assert int((scat[p] != 0).sum()) == int((vals[p * nl:(p + 1) * nl]
                                                 != 0).sum())
    hub = tp.mode_values(pg, vals, "hub")
    assert torch.equal(hub[:, pg.hubs.long()],
                       vals[pg.hubs.long()].expand(4, -1))
    bad = vals.clone()
    bad[0] = float("nan")
    got = tp.distributed_join_group_by(pg, bad, mode="allgather")
    # padded rows point at dst 0 with src 0: NaN * 0 = NaN, as in XLA
    assert bool(torch.isnan(got[0]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_offline_plane_rehearsal():
    """Phase 6 of chip_smoke.py on the CPU at a small size: the timeline,
    the three partition modes within their bound (each planted fault
    exceeds it), the programming models, views and schema."""
    cs = _chip_smoke()
    tl = cs.offline_timeline(torch, "cpu", 2048, 8, 2000)
    assert tl["full_builds"] + tl["delta_patches"] == 8
    assert len(tl["iterations"]) == 8 and tl["pagerank_max_diff"] == 0.0
    parts = cs.check_partition_modes(torch, tl["view"], 16, 64)
    assert sorted(parts["modes"]) == sorted(MODES)
    assert len(parts["planted"]) == 2
    assert all(x > 0 for x in parts["planted"].values())
    models = cs.check_models(torch, tl["view"], "cpu",
                             pregel_stream=(256, 3, 256))
    assert models["dataflow_events"] == 15
    assert len(cs.check_views_and_schema(torch, tl["graph"],
                                         tl["versions"])["top_growth"]) == 3


def test_chip_smoke_partition_check_fails_a_broken_mode(monkeypatch):
    """A mode that loses the last partition's partials fails the check."""
    cs = _chip_smoke()
    _, tv = _views(256, 4, 600)
    real = tp.distributed_join_group_by

    def broken(pg, values, *, mode="scatter"):
        if mode != "hub":
            return real(pg, values, mode=mode)
        part = tp.local_partials(pg, tp.mode_values(pg, values, mode))
        return part[:-1].sum(0)
    monkeypatch.setattr(tp, "distributed_join_group_by", broken)
    with pytest.raises(cs.SmokeFailure, match="partition hub"):
        cs.check_partition_modes(torch, tv, 4, 8)
