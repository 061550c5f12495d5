"""CPU tests of the benchmark harness (``bench/``), at tiny sizes.

They run each cell's whole run (set-up, window, load generator process,
check) on the CPU with a scale-10 Kronecker stream, see ``correct`` come
out true on the sound program and false with the bfloat16 control or with
a fault planted in the program underneath, and hold the manifest, the
stream, the roofline count and the import rule to what the harness
promises.
"""
from __future__ import annotations

import copy
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import check, harness, loadgen  # noqa: E402
from benchlib import manifest as mf  # noqa: E402
from benchlib.reference import RefGraph, live_graph  # noqa: E402
from benchlib.stream import KroneckerStream, Layout  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the manifest, plus the serving cells whose files are staged for a later
# PR (bench/traffic/{ingest,zipf}.json, bench/configs/kron20-hub.json and
# their metric readers; PERF.md section 7), so their harness path stays
# tested
MANIFEST = mf.load()
MANIFEST["configs"].append({"name": "kron20-hub",
                            "file": "bench/configs/kron20-hub.json"})
MANIFEST["workloads"] += [
    {"name": "kron20.ingest", "config": "kron20", "traffic": "ingest",
     "chips": 1},
    {"name": "kron20-hub.zipf", "config": "kron20-hub", "traffic": "zipf",
     "chips": 1}]
MANIFEST["end_to_end"] += [
    {"name": name, "unit": "x", "workloads": cells} for name, cells in (
        ("ingest_mut_per_s", ["kron20.ingest"]),
        ("query_p50_ms", ["kron20.ingest", "kron20-hub.zipf"]),
        ("query_p99_ms", ["kron20.ingest"]),
        ("query_p95_ms", ["kron20-hub.zipf"]))]
# the graph cells (bench/test_bench_generate.py tests the model cell)
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if mf.cell(MANIFEST, w["name"])[2]["driver"] in ("serve",
                                                           "timeline")]


def tiny(workload: str) -> tuple[dict, dict]:
    """The cell's configuration and traffic at scale 10 (4,096 live
    edges in blocks of 256), with a 1.5 s window."""
    _, cfg, tr = mf.cell(MANIFEST, workload)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["generator"]["scale"] = 10
    cfg["block_edges"] = 256
    cfg["base_blocks"] = 16
    if tr["driver"] == "serve":
        tr["writer"]["epoch_blocks"] = min(tr["writer"]["epoch_blocks"], 2)
        if tr["writer"]["mode"] == "open":
            tr["writer"]["period_s"] = 0.1
        tr["warm_s"] = 0.5
        tr["capacity_epochs"] = 4000
        tr["queries"]["rate_per_s"] = 40
        tr["queries"]["wait_s"] = 20
    else:
        tr["epoch_blocks"] = 2
    return cfg, tr


def run_tiny(workload: str, seed: int = 2**31 + 5, control: bool = False):
    cfg, tr = tiny(workload)
    return harness.run_once(MANIFEST, workload, seed, 1.5, device="cpu",
                            t_proc=time.monotonic(), config=cfg, traffic=tr,
                            control=control)


def test_stream_is_deterministic_from_seed():
    gen = {"scale": 10, "A": 0.57, "B": 0.19, "C": 0.19, "label_seed": 1}
    a = KroneckerStream(gen, 512, 2**33 + 1, "cpu")
    b = KroneckerStream(gen, 512, 2**33 + 1, "cpu")
    c = KroneckerStream(gen, 512, 2**33 + 2, "cpu")
    for blk in (0, 7):
        assert all(torch.equal(x, y) for x, y in zip(a.draw(blk), b.draw(blk)))
    assert not torch.equal(a.draw(3)[0], c.draw(3)[0])
    assert not torch.equal(a.draw(3)[0], a.draw(4)[0])
    assert torch.equal(a.perm, c.perm)
    src, dst = a.draw(0)
    assert src.dtype == torch.int32 and int(src.max()) < 1024
    assert int(dst.min()) >= 0
    # Kronecker skew: the busiest destination takes far more than 1/n
    assert int(torch.bincount(dst.long()).max()) > 8 * 512 / 1024
    lay = Layout(16, 4, 2)
    assert list(lay.live_blocks(3)) == list(range(16))
    assert list(lay.added_blocks(4)) == [16, 17]
    assert list(lay.deleted_blocks(4)) == [0, 1]
    assert list(lay.live_blocks(5)) == list(range(4, 20))


def test_load_schedule_same_work_every_seed():
    mix = tiny("kron20.ingest")[1]["queries"]["mix"]
    keys = loadgen.Keys({"dist": "zipf", "theta": 0.99}, 1024, 9,
                        np.random.default_rng(1).permutation(1024))
    t1, f1 = loadgen.schedule(9, 1, 40, 2.0, mix, keys)
    t2, f2 = loadgen.schedule(10, 1, 40, 2.0, mix, keys)
    assert len(t1) == len(t2) == 80
    kinds = sorted(f["kind"] for f in f1)
    assert kinds == sorted(f["kind"] for f in f2)
    assert kinds.count("k_hop") == 40 and kinds.count("pagerank") == 4
    assert np.array_equal(t1, loadgen.schedule(9, 1, 40, 2.0, mix, keys)[0])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_against_reference_on_cpu(workload):
    run, metrics, correct, checks, _ = run_tiny(workload)
    assert correct, checks
    assert run.attempted > 0 and run.failed == 0
    for m in mf.metrics_for(MANIFEST, workload, False):
        assert m["name"] in metrics, (m["name"], metrics)
        assert metrics[m["name"]]["value"] > 0


# the graph cells' compared numbers and limits, as they stood before each
# driver owned its check
CHECKED = {
    "timeline": {"snapshot_mismatch": 0, "pagerank_l1": 0.005,
                 "wcc_mismatch": 0},
    "serve": {"snapshot_mismatch": 0, "lost_epochs": 0, "unanswered": 0,
              "unpublished_version": 0, "khop_mismatch": 0,
              "reach_mismatch": 0, "topk_mismatch": 0,
              "pagerank_topk_rel": 0.01}}


@pytest.mark.parametrize("workload", CELLS)
def test_driver_numbers_are_the_checks_of_before(workload):
    run, _, correct, checks, state = run_tiny(workload)
    cfg, tr = run.config, run.traffic
    assert {k: c["limit"] for k, c in checks.items()} == \
        CHECKED[tr["driver"]]
    ref_kw = cfg["reference_pagerank"]
    if tr["driver"] == "serve":
        direct = check.serve_numbers(run, state["stream"], state["layout"],
                                     ref_kw)
    else:
        direct = check.timeline_numbers(state["results"], state["stream"],
                                        state["layout"], ref_kw)
    assert {k: c["value"] for k, c in checks.items()} == direct
    assert correct


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_lower_precision_is_not_correct(workload):
    _, _, correct, checks, _ = run_tiny(workload, control=True)
    assert not correct, checks


def _fault_state_unchanged(monkeypatch, base_epochs):
    from repro_torch.graph.dyngraph import MutationBatch
    from repro_torch.graph.sharded import ShardedDynamicGraph
    orig = ShardedDynamicGraph.ingest

    def ingest(self, batch):
        if batch.version.epoch >= base_epochs:
            batch = MutationBatch(batch.version)
        return orig(self, batch)

    monkeypatch.setattr(ShardedDynamicGraph, "ingest", ingest)


def _fault_half_batch(monkeypatch, base_epochs):
    from repro_torch.graph.dyngraph import MutationBatch
    from repro_torch.graph.sharded import ShardedDynamicGraph
    orig = ShardedDynamicGraph.ingest

    def ingest(self, batch):
        a, d = len(batch.add_src) // 2, len(batch.del_src) // 2
        return orig(self, MutationBatch(
            batch.version, batch.add_src[:a], batch.add_dst[:a],
            batch.del_src[:d], batch.del_dst[:d]))

    monkeypatch.setattr(ShardedDynamicGraph, "ingest", ingest)


def _fault_shard_left_out(monkeypatch, base_epochs):
    from repro_torch.graph import sharded
    orig = sharded.stitch_join_views
    monkeypatch.setattr(sharded, "stitch_join_views",
                        lambda version, views, **kw: orig(version, views[:-1],
                                                          **kw))


def _fault_answer_altered(monkeypatch, base_epochs):
    from repro_torch.graph import compute
    from repro_torch.graph.query import SnapshotQueryEngine
    orig = SnapshotQueryEngine._execute_groups

    def execute(self, view, queries, routed):
        values = orig(self, view, queries, routed)
        return [np.logical_not(v) if isinstance(v, np.ndarray)
                and v.dtype == np.bool_ else v for v in values]

    monkeypatch.setattr(SnapshotQueryEngine, "_execute_groups", execute)
    wcc = compute.wcc

    def altered(view, max_rounds=1000):
        labels = wcc(view, max_rounds).clone()
        labels[0] += 1
        return labels

    monkeypatch.setattr(compute, "wcc", altered)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "shard_left_out": _fault_shard_left_out,
          "answer_altered": _fault_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch, tiny(workload)[0]["base_epochs"])
    _, _, correct, checks, _ = run_tiny(workload)
    assert not correct, checks


def test_pagerank_that_returns_its_start_is_not_correct(monkeypatch):
    from repro_torch.graph import compute
    orig = compute.pagerank

    def stuck(view, **kw):
        res = orig(view, **kw)
        start = kw.get("init")
        if start is None:
            start = torch.full((view.n,), 1.0 / view.n)
        return compute.PageRankResult(start, res.iterations, res.residual)

    monkeypatch.setattr(compute, "pagerank", stuck)
    _, _, correct, checks, _ = run_tiny("kron20.timeline")
    assert not correct and checks["pagerank_l1"]["value"] > \
        checks["pagerank_l1"]["limit"], checks


def test_reference_semantics_on_a_hand_graph():
    # 0 -> 1 -> 2 -> 3, 0 -> 1 twice, 4 isolated, 5 <-> 6
    src = torch.tensor([0, 0, 1, 2, 5, 6], dtype=torch.int32)
    dst = torch.tensor([1, 1, 2, 3, 6, 5], dtype=torch.int32)
    g = RefGraph(src, dst, 7)
    assert g.k_hop(0, 2).tolist() == [True, True, True, False, False, False,
                                      False]
    assert g.reachable(0, 3, 3) and not g.reachable(0, 3, 2)
    assert not g.reachable(3, 0, 8)
    ids, degs = g.degree_topk(3)
    assert ids.tolist() == [1, 2, 3] and degs.tolist() == [2, 1, 1]
    assert g.wcc().tolist() == [0, 0, 0, 0, 4, 5, 5]
    ranks, _ = g.pagerank()
    assert abs(float(ranks.sum()) - 1.0) < 1e-12


def test_manifest_names_units_and_files():
    m = mf.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[g]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    e2e = {x["name"] for x in m["end_to_end"]}
    assert {"setup_s", "timeline_evps"} <= e2e
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower",
                                                             "higher")
        assert (BENCH / "metrics" / f"{x['name']}.py").exists(), x["name"]
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "\n" not in x["layer"]
        for w in x["workloads"]:
            assert w in {c["name"] for c in m["workloads"]}
    for c in m["configs"]:
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        _, cfg, tr = mf.cell(m, w["name"])
        assert cfg["limits"] and all(v >= 0 for v in cfg["limits"].values())
        for key in (c for c in m["configs"] if c["name"] == w["config"]) \
                .__next__()["reduced"]:
            assert NAME.match(key) and key in cfg.get("generator", cfg)
        reported = [x for x in m["end_to_end"] if "workloads" not in x
                    or w["name"] in x["workloads"]]
        assert len(reported) >= 2
        assert any(w["name"] in x["workloads"] for x in m["per_layer"])
    for c in m["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert len(c["source"]) <= 200
    assert len(json.dumps(m)) < 64 * 1024


def test_segment_sum_count_matches_perf_table():
    from benchlib.roofline import bound_s, load_count
    count = load_count("segment_sum")
    table = (ROOT / "PERF.md").read_text()
    for m, ms in ((4_161_140, "0.0112"), (6_731_579, "0.0173")):
        got = bound_s(count, {"m": m, "n": 1_048_576, "f": 1}) * 1e3
        assert f"{got:.4f}" == ms
        assert re.search(rf"m = {m:,}.*\| {ms} \(bytes\)", table)


def test_harness_loads_no_jax_and_reference_no_program():
    code = (
        "import sys; sys.path[:0] = ['bench', 'src']\n"
        "import benchlib.reference, benchlib.stream, benchlib.loadgen\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert not mods & {'repro_torch'}, 'reference loads the program'\n"
        "import benchlib.harness, benchlib.serve, benchlib.timeline\n"
        "import benchlib.program, benchlib.trace, repro_torch.launch.rpc\n"
        "import repro_torch.launch.serve_graph, repro_torch.graph.compute\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "bad = mods & {'jax', 'jaxlib', 'flax', 'repro'}\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         str(2**31 + 11), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not out.stdout.strip()


def test_limits_hold_numbers_against_the_configuration():
    ok, checks = check.judge({"khop_mismatch": 0, "pagerank_l1": 2e-4},
                             {"khop_mismatch": 0, "pagerank_l1": 1e-4})
    assert not ok and checks["khop_mismatch"]["value"] == 0
    g = live_graph(KroneckerStream({"scale": 8, "A": 0.57, "B": 0.19,
                                    "C": 0.19, "label_seed": 1}, 128, 3,
                                   "cpu"),
                   Layout(8, 4, 1), 5)
    assert g.m == 8 * 128
