"""The port's spans (``repro_torch.trace``) on the CPU: off outside a
profiler session, on inside one; how they nest across the write plane's
threads, their counts against the results, their place among the
profiler's own events, the buffer's bound, and answers that do not move
when spans are on."""
import collections
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.core.versioned import Version  # noqa: E402
from repro_torch.graph import compute as gc  # noqa: E402
from repro_torch.graph.dyngraph import synthesize_stream  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph  # noqa: E402
from repro_torch.launch.serve_graph import GraphQueryServer  # noqa: E402

N, EPOCHS, ADDS = 256, 6, 400
NAMES = ("Compute.", "Store.", "Write.")


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def batches():
    return synthesize_stream(N, EPOCHS, ADDS, seed=7, delete_frac=0.2,
                             device="cpu")[1]


def _store(parallel_apply: int) -> ShardedDynamicGraph:
    return ShardedDynamicGraph(4, N, EPOCHS * ADDS, device="cpu",
                               parallel_apply=parallel_apply)


def _cpu_profile(all_threads: bool = False):
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads \
        else None
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=cfg)


def _serve_and_compute(batches, parallel_apply: int):
    """Steps a mirrored server through the stream, then PageRank and WCC
    on the newest version; returns the two results."""
    sg = _store(parallel_apply)
    srv = GraphQueryServer(sg, replicate_hot=True)
    try:
        for b in batches:
            srv.step(b)
        view = sg.join_view(sg.latest_sealed())
        return gc.pagerank(view), gc.wcc(view)
    finally:
        srv.stop_prewarm()
        sg.shutdown()


def test_off_records_nothing_and_hands_out_one_handle(batches):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("Compute.a") is trace.span("Write.b", x=1) is trace.OFF
    with trace.span("Compute.a", parent=3) as sp:
        sp.set(k=2)
        assert sp.timed("wait_s", int, "7") == 7
    assert sp is trace.OFF and sp.id is None
    _serve_and_compute(batches[:3], 4)
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.parametrize("parallel_apply", [0, 4])
def test_spans_nest_as_designed(batches, parallel_apply):
    with _cpu_profile():
        _serve_and_compute(batches, parallel_apply)
    records = trace.spans()
    by_id = {s.id: s for s in records}
    assert len(by_id) == len(records)

    def parent(s):
        return by_id[s.parent].name if s.parent in by_id else None

    expected = {"Compute.pagerank.iter": {"Compute.pagerank"},
                "Compute.wcc.round": {"Compute.wcc"},
                "Write.drain_touches": {"Write.step"},
                "Write.reshard_tick": {"Write.step"},
                "Write.ingest": {"Write.step"},
                "Write.seal": {"Write.step"},
                "Write.shard_apply": {"Write.seal"},
                "Write.unique": {"Write.shard_apply"},
                "Write.publish": {"Write.seal"},
                "Write.replica_plan": {"Write.publish"},
                "Store.join_view": {"Write.publish", "Write.replica_plan",
                                    None},
                "Store.shard_view": {"Store.join_view",
                                     "Write.replica_plan"},
                "Store.stitch": {"Store.join_view"},
                "Write.step": {None}, "Compute.pagerank": {None},
                "Compute.wcc": {None}}
    seen = collections.Counter(s.name for s in records)
    assert set(seen) == set(expected), seen
    for s in records:
        assert parent(s) in expected[s.name], (s.name, parent(s))
        assert s.start <= s.end
        if s.parent in by_id:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert seen["Write.step"] == seen["Write.seal"] == len(batches)
    assert seen["Write.shard_apply"] == 4 * len(batches)
    applies = [s for s in records if s.name == "Write.shard_apply"]
    assert sorted(s.attrs["shard"] for s in applies) == \
        sorted(list(range(4)) * len(batches))
    off_thread = {s.thread != by_id[s.parent].thread for s in applies}
    assert off_thread == ({True} if parallel_apply > 1 else {False})
    # every span of a step carries the step's epoch
    for s in records:
        root = s
        while root.parent in by_id:
            root = by_id[root.parent]
        if root.name == "Write.step":
            assert s.attrs["epoch"] == root.attrs["epoch"], s.name
    steps = [s for s in records if s.name == "Write.step"]
    assert [s.attrs["adds"] for s in steps] == \
        [len(b.add_src) for b in batches]
    assert [s.attrs["deletes"] for s in steps] == \
        [len(b.del_src) for b in batches]
    for s in applies:
        assert s.attrs["rows"] >= 0
    kinds = {s.attrs["kind"] for s in records if s.name == "Store.shard_view"}
    assert kinds <= {"delta", "full"} and "full" in kinds


def test_counts_are_the_results(batches):
    with _cpu_profile():
        pr, _ = _serve_and_compute(batches, 0)
    records = trace.spans()
    (prs,) = [s for s in records if s.name == "Compute.pagerank"]
    (wccs,) = [s for s in records if s.name == "Compute.wcc"]
    iters = [s for s in records if s.parent == prs.id]
    rounds = [s for s in records if s.parent == wccs.id]
    assert prs.attrs["iterations"] == pr.iterations == len(iters)
    assert prs.attrs["residual"] == pr.residual
    assert prs.attrs["warm"] is False and prs.attrs["n"] == N
    assert wccs.attrs["rounds"] == len(rounds) > 1
    assert {s.name for s in iters} == {"Compute.pagerank.iter"}
    assert {s.name for s in rounds} == {"Compute.wcc.round"}
    for s in iters + rounds:
        assert 0 <= s.attrs["wait_s"] <= s.end - s.start


def test_every_span_is_a_profiler_event_with_its_nesting(batches):
    with _cpu_profile(all_threads=True) as prof:
        _serve_and_compute(batches[:4], 4)
    records = trace.spans()
    by_id = {s.id: s for s in records}

    def ours(s):
        p = by_id.get(s.parent)
        return s.name, (p.name if p is not None and p.thread == s.thread
                        else None)

    def theirs(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(NAMES):
            p = p.cpu_parent
        return e.name, (p.name if p is not None else None)

    events = [e for e in prof.events() if e.name.startswith(NAMES)]
    assert collections.Counter(map(ours, records)) == \
        collections.Counter(map(theirs, events))
    # host ranges only: a user annotation would also draw a device range,
    # which a device trace counts as time on the card
    assert not any(e.is_user_annotation for e in events)
    assert any(s.name == "Write.shard_apply" for s in records)


def test_window_bound_and_dropped_count(monkeypatch):
    monkeypatch.setattr(trace, "_BUFFER", trace._Buffer(4))
    with _cpu_profile():
        for i in range(10):
            with trace.span("Compute.x", i=i):
                pass
    kept = trace.spans()
    assert [s.attrs["i"] for s in kept] == [6, 7, 8, 9]
    assert trace.dropped() == 6
    mid = kept[1].end
    assert [s.attrs["i"] for s in trace.spans(t0=mid)] == [7, 8, 9]
    assert [s.attrs["i"] for s in trace.spans(t1=mid)] == [6, 7]
    assert trace.spans(mid, mid) == [kept[1]]
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_threads_lose_no_record(monkeypatch):
    workers, each, cap = 16, 200, 1000
    monkeypatch.setattr(trace, "_BUFFER", trace._Buffer(cap))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(w):
            for i in range(each):
                with trace.span("Write.x", w=w, i=i):
                    with trace.span("Write.y"):
                        pass

        with _cpu_profile():
            threads = [threading.Thread(target=work, args=(w,))
                       for w in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = 2 * workers * each
    kept = trace.spans()
    assert len(kept) == cap and trace.dropped() == total - cap
    assert len({s.id for s in kept}) == cap
    by_id = {s.id: s for s in kept}
    for s in kept:
        if s.name == "Write.y" and s.parent in by_id:
            assert by_id[s.parent].thread == s.thread


def test_answers_bit_identical_with_spans_on_and_off(batches):
    stores = {}
    for on in (False, True):
        sg = _store(4)
        if on:
            with _cpu_profile():
                for b in batches:
                    sg.apply(b)
                views = [sg.join_view(Version(e, 0)) for e in range(EPOCHS)]
                pr = [gc.pagerank(v) for v in views]
                labels = [gc.wcc(v) for v in views]
            assert trace.spans()
        else:
            for b in batches:
                sg.apply(b)
            views = [sg.join_view(Version(e, 0)) for e in range(EPOCHS)]
            pr = [gc.pagerank(v) for v in views]
            labels = [gc.wcc(v) for v in views]
            assert not trace.spans()
        sg.shutdown()
        stores[on] = views, pr, labels
    (v0, p0, l0), (v1, p1, l1) = stores[False], stores[True]
    for a, b in zip(v0, v1, strict=True):
        for f in ("offsets", "src", "dst", "out_degree", "in_degree"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for a, b in zip(p0, p1, strict=True):
        assert torch.equal(a.ranks, b.ranks)
        assert (a.iterations, a.residual) == (b.iterations, b.residual)
    for a, b in zip(l0, l1, strict=True):
        assert torch.equal(a, b)
