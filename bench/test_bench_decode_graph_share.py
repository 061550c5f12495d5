"""``decode_graph_share.batch2k`` (a staged reader: no manifest entry yet)
on a synthetic run: the share of the program's ``Model.decode`` spans in
the traced sub-window whose ``route`` is "graph", read through
``repro_torch.trace``'s buffer as a traced run reads it, and None where
the program left no such span (as a program without the decode graph
does)."""
from __future__ import annotations

import pathlib
import sys
import types

import pytest

pytest.importorskip("torch")

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import manifest as mf  # noqa: E402

from repro_torch import trace  # noqa: E402

NAME = "decode_graph_share.batch2k"
T0, T1 = 100.0, 110.0


def _run(monkeypatch, routes, name="Model.decode", start=T0 + 1.0):
    """A traced run over [T0, T1] whose program recorded one span called
    ``name`` a step, with these routes, 0.03 s apart from ``start``."""
    buf = trace._Buffer(trace.CAPACITY)
    monkeypatch.setattr(trace, "_BUFFER", buf)
    for i, route in enumerate(routes):
        s = trace.Span(name, None, {"route": route, "captured": i == 0})
        s.start = start + 0.03 * i
        s.end = s.start + 0.028
        buf.add(s)
    return types.SimpleNamespace(trace={"t0": T0, "t1": T1})


@pytest.mark.parametrize("routes,want", [
    (["graph"] * 32, 100.0),
    (["graph"] * 24 + ["eager"] * 8, 75.0),
    (["eager"] + ["graph"] * 3, 75.0),
    (["eager"] * 32, 0.0),
])
def test_share_of_graph_steps(monkeypatch, routes, want):
    run = _run(monkeypatch, routes)
    assert mf.reader(NAME)(run) == pytest.approx(want)


def test_no_decode_spans_read_none(monkeypatch):
    assert mf.reader(NAME)(_run(monkeypatch, [])) is None
    # spans of another name, or outside the traced sub-window
    assert mf.reader(NAME)(_run(monkeypatch, ["graph"] * 4,
                                name="Model.moe")) is None
    assert mf.reader(NAME)(_run(monkeypatch, ["graph"] * 4,
                                start=T1 + 1.0)) is None
    # an untraced run
    run = _run(monkeypatch, ["graph"] * 4)
    run.trace = None
    assert mf.reader(NAME)(run) is None
