"""The port's protocol-dataflow runtime, Lamport clocks, distributed views
and evolving schemas against the JAX package's: the same dataflow,
clock traffic, lineage or schema declarations fed to both give the same
events, stamps, delivery order and answers."""
from collections import deque

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import clock as rclock  # noqa: E402
from repro.core import protocol_dataflow as rdf  # noqa: E402
from repro.core import views as rviews  # noqa: E402
from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import schema as rschema  # noqa: E402
from repro_torch.core import clock as tclock  # noqa: E402
from repro_torch.core import protocol_dataflow as tdf  # noqa: E402
from repro_torch.core import views as tviews  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import schema as tschema  # noqa: E402


def _stamps(stamps):
    return [(s.time, s.node_id) for s in stamps]


def _events(events):
    return [(e.stamp.time, e.stamp.node_id, e.kind, e.payload)
            for e in events]


# ----------------------------------------------------------------- clocks
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lamport_condition_and_stamps_equal_reference(seed):
    """Send/receive traffic between 4 clocks: every receive is after its
    send (the Lamport condition) and both packages stamp alike."""
    sends = np.random.default_rng(seed).integers(0, 4, (60, 2))
    stamps = {}
    for mod in (rclock, tclock):
        clocks = [mod.LamportClock(i) for i in range(4)]
        out = []
        for src, dst in sends:
            s = clocks[src].send()
            r = clocks[dst].receive(s)
            assert s < r
            out += [s, r, clocks[int(src)].tick()]
        stamps[mod] = _stamps(out)
    assert stamps[tclock] == stamps[rclock]


def test_event_log_causal_delivery_equals_reference():
    delivered = {}
    for mod in (rclock, tclock):
        log = mod.EventLog()
        seen = []
        log.observe("recv", seen.append)
        c1, c2 = mod.LamportClock(1), mod.LamportClock(2)
        for i in range(3):
            s = c1.send()
            log.record(mod.Event(s, "send", {"id": i}))
            log.record(mod.Event(c2.receive(s), "recv", {"id": i}))
        log.register_relation(
            lambda e1, e2: True if (e1.kind == "send" and e2.kind == "recv"
                                    and e1.payload["id"] == e2.payload["id"])
            else None)
        out = log.deliver()
        assert log.check_causal_consistency(out)
        assert not log.check_causal_consistency(out[::-1])
        assert [e.payload["id"] for e in seen] == [0, 1, 2]
        assert log.deliver() == []            # delivered once
        delivered[mod] = _events(out)
    assert delivered[tclock] == delivered[rclock]


# ------------------------------------------------------------- schedulers
def _messages(mod_clock, mod_df, payloads):
    return deque(mod_df.Message(mod_clock.Stamp(i, 0), 0, p)
                 for i, p in enumerate(payloads))


@pytest.mark.parametrize("budget", [1, 3, 100])
def test_fifo_and_priority_schedulers_equal_reference(budget):
    payloads = [5, 1, 4, 1, 5, 9, 2, 6]
    for sched in ("fifo", "priority"):
        picked = {}
        for mc, md in ((rclock, rdf), (tclock, tdf)):
            s = (md.FIFOScheduler() if sched == "fifo"
                 else md.PriorityScheduler(key=lambda p: -p))
            q = _messages(mc, md, payloads)
            rounds = []
            while True:
                batch = s.select(q, budget)
                if not batch:
                    break
                rounds.append([(m.stamp.time, m.payload) for m in batch])
            picked[md] = rounds
        assert picked[tdf] == picked[rdf], sched
        flat = [p for r in picked[tdf] for _, p in r]
        assert flat == (payloads if sched == "fifo"
                        else sorted(payloads, reverse=True))


def test_coalescing_output_equals_reference():
    msgs = [("a", 3), ("b", 4), ("a", 6), ("a", 7), ("b", 1), ("c", 3)]
    out = {}
    for md in (rdf, tdf):
        co = md.CoalescingOutput(key=lambda p: p % 3,
                                 combine=lambda x, y: x + y)
        out[md] = co.emit(list(msgs))
        assert md.IdentityOutput().emit(list(msgs)) == msgs
    # keys (port, payload % 3) in first-seen order, payloads summed
    assert out[tdf] == out[rdf] == [("a", 9), ("b", 5), ("a", 7), ("c", 3)]


# --------------------------------------------------------------- dataflow
def _run_dataflow(md):
    """ingress -> prio (priority scheduler, budget 2) -> coal (coalescing
    output) -> egress, over three epochs; returns what the dataflow
    delivered, the egress received and the rounds per epoch."""
    proto = md.Protocol(
        "test", validate=lambda p: isinstance(p, int),
        happens_before=lambda e1, e2: (
            True if (e1.kind == e2.kind == "send"
                     and e1.payload["src"] == "ingress"
                     and e2.payload["src"] == "coal"
                     and e1.payload["epoch"] < e2.payload["epoch"])
            else None))
    df = md.Dataflow("test")
    ingress = df.add(md.Ingress("ingress", proto, encode=lambda p: p * 10))

    def prio_fn(vertex, port, xs):
        vertex.emit_event("batch", {"size": len(xs)})
        return [("out", x + 1) for x in xs]
    prio = df.add(md.Vertex(
        "prio", proto, prio_fn, budget=2,
        input_scheduler=md.PriorityScheduler(key=lambda p: -p)))
    coal = df.add(md.Vertex(
        "coal", proto, lambda v, port, xs: [("out", x) for x in xs],
        output_scheduler=md.CoalescingOutput(key=lambda p: p % 2,
                                             combine=lambda a, b: a + b)))
    got = []
    egress = df.add(md.Egress("egress", proto, got.append))
    ingress.connect("out", prio)
    prio.connect("out", coal)
    coal.connect("out", egress)
    rounds = []
    for epoch in range(3):
        ingress.push([epoch, 3, 1, 4 + epoch], epoch=epoch)
        rounds.append(df.run_until_quiescent())
    delivered = df.deliver_events()
    assert egress.received == got
    return _events(delivered), got, rounds


def test_dataflow_events_and_stamps_equal_reference():
    want = _run_dataflow(rdf)
    got = _run_dataflow(tdf)
    assert got == want
    events, received, _ = got
    assert [t for t, *_ in events] == sorted(t for t, *_ in events)
    assert {k for _, _, k, _ in events} == {"send", "batch"}
    assert len(received) > 0


def test_dataflow_errors_equal_reference():
    msgs = {}
    for md in (rdf, tdf):
        proto = md.Protocol("ints", validate=lambda p: isinstance(p, int))
        df = md.Dataflow("bad")
        ingress = df.add(md.Ingress("ingress", proto))
        sink = df.add(md.Vertex("sink", proto))
        ingress.connect("out", sink)
        with pytest.raises(ValueError) as bad:
            ingress.push(["x"])
        ingress.push([1])
        with pytest.raises(NotImplementedError) as nofn:
            df.run_until_quiescent()
        loop = md.Dataflow("loop")
        a = loop.add(md.Vertex("a", proto, lambda v, p, xs: [("out", 1)]))
        a.connect("out", a)
        a.deliver("in", md.Message(md.Stamp(0, 0), 0, 1))
        with pytest.raises(RuntimeError) as spin:
            loop.run_until_quiescent(max_rounds=5)
        msgs[md] = [str(bad.value), str(nofn.value), str(spin.value)]
    assert msgs[tdf] == msgs[rdf]


# ------------------------------------------------------------------ views
def _lineage(mv, version):
    calls = {"n": 0}

    def produce():
        calls["n"] += 1
        return list(range(10))
    base = mv.View.source("base", produce, snapshot=version(1, 0))
    doubled = base.map("doubled", lambda xs: [2 * x for x in xs])
    other = mv.View.source("other", lambda: 5, snapshot=version(2, 3))
    total = mv.View.join("total", lambda xs, k: sum(xs) + k, doubled, other)
    first = total.value()
    assert calls["n"] == 1
    total.invalidate()                       # only the top is lost
    assert total.recover() == first and calls["n"] == 1
    total.invalidate(recursive=True)
    again = total.recover()                  # replayed along the lineage
    return (first, again, calls["n"], total.lineage(),
            total.spec.snapshot.pack(), doubled.spec.snapshot.pack())


def test_view_lineage_recovery_equals_reference():
    got = _lineage(tviews, TV)
    assert got == _lineage(rviews, RV)
    assert got[:3] == (95, 95, 2)
    assert got[3] == ["base", "doubled", "other", "total"]


# ----------------------------------------------------------------- schema
def _schema_answers(ms):
    reg = ms.citation_schema()
    types = ("Author", "Paper", "School")
    keys = [(t, v) for t in types for v in reg.versions_of(t)]
    props = [{"name": "a"}, {"contact": "b"}, {"name": "a", "contact": "b"},
             {"name": 3}, {"title": "t"}, {}]
    out = [[reg.versions_of(t) for t in types],
           [reg.fields_of(*k) for k in keys],
           [reg.type_id(*k) for k in keys],
           [reg.link_allowed(a, b) for a in keys for b in keys],
           [reg.validate(*k, p) for k in keys for p in props]]
    errors = []
    for call in (lambda: reg.declare_node("Author", 1, {"x": "Int"}),
                 lambda: reg.declare_node("Venue", 2, {}, inherits=1),
                 lambda: reg.declare_link("Author", "Venue"),
                 lambda: reg.declare_link("Author", "Paper", src_version=7),
                 lambda: reg.fields_of("Paper", 2)):
        with pytest.raises((ValueError, KeyError)) as exc:
            call()
        errors.append((type(exc.value).__name__, str(exc.value)))
    return out, errors


def test_citation_schema_answers_equal_reference():
    got = _schema_answers(tschema)
    assert got == _schema_answers(rschema)
    answers, _ = got
    assert answers[1][1] == {"name": "String", "contact": "String"}
