"""CPU tests of the readers of the program's spans (``bench/benchlib/
program_spans.py`` and the metrics that use it): the timeline cell and
the staged ``kron20.ingest`` cell run whole at scale 10 under a CPU
profiler, with the traced sub-window set by hand to the run's."""
from __future__ import annotations

import math
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchlib import harness  # noqa: E402
from benchlib import manifest as mf  # noqa: E402
from test_bench_harness import MANIFEST, tiny  # noqa: E402

from repro_torch import trace  # noqa: E402

READERS = {"kron20.timeline": ["wcc_rounds.timeline", "wcc_round_ms.timeline",
                               "pagerank_issue_us.timeline",
                               "wcc_issue_us.timeline"],
           "kron20.ingest": ["shard_apply_ms.ingest", "publish_ms.ingest"]}


def _profiled_run(workload: str):
    cfg, tr = tiny(workload)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.monotonic()
        run, _, correct, checks, _ = harness.run_once(
            MANIFEST, workload, 2**31 + 17, 1.5, device="cpu",
            t_proc=time.monotonic(), config=cfg, traffic=tr)
        t1 = time.monotonic()
    assert correct, checks
    return run, t0, t1


@pytest.mark.parametrize("workload", sorted(READERS))
def test_span_readers_read_a_profiled_run(workload):
    run, t0, t1 = _profiled_run(workload)
    names = READERS[workload]
    try:
        run.trace = {"t0": t0, "t1": t1}
        values = {n: mf.reader(n)(run) for n in names}
        run.trace = None
        untraced = {n: mf.reader(n)(run) for n in names}
    finally:
        trace.clear()
    for n, v in values.items():
        assert v is not None and math.isfinite(v) and v > 0, (n, v)
    assert untraced == dict.fromkeys(names)


def test_wcc_readers_agree_with_the_harness_span():
    run, _, t1 = _profiled_run("kron20.timeline")
    # from the window's open: the WCC calls the harness timed, each inside
    # its own ``wcc`` span
    run.trace = {"t0": run.t_open, "t1": t1}
    try:
        rounds = mf.reader("wcc_rounds.timeline")(run)
        round_ms = mf.reader("wcc_round_ms.timeline")(run)
        program = [s for s in trace.spans(run.t_open, t1)
                   if s.name == "Compute.wcc"]
    finally:
        trace.clear()
    calls = [s for s in run.spans if s[0] == "wcc"]
    assert len(program) == len(calls) > 0
    harness_ms = sum(e - s for _, s, e, _ in calls) / len(calls) * 1e3
    assert 0 < rounds * round_ms <= harness_ms


def test_manifest_lists_the_span_metrics_for_the_timeline():
    listed = {m["name"] for m in mf.metrics_for(mf.load(), "kron20.timeline",
                                                True)}
    assert set(READERS["kron20.timeline"]) <= listed
