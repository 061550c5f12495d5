"""The program's own spans (``repro_torch.trace``) over a traced
sub-window, for the readers of per-layer metrics.

The program records its spans while a ``torch.profiler`` session records,
so a ``--trace 1`` run holds them for the sub-window ``run.trace`` spans.
Without a trace, or with a program that has no ``repro_torch.trace``,
there is nothing to read: the helpers return None and the reader leaves
its metric out.
"""
from __future__ import annotations

from typing import Optional


def named(run, name: str) -> Optional[list]:
    """The program's spans called ``name`` that ended inside the traced
    sub-window, or None when there are none to read."""
    if not run.trace:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    found = [s for s in trace.spans(run.trace["t0"], run.trace["t1"])
             if s.name == name]
    return found or None


def issue_us(run, name: str) -> Optional[float]:
    """Mean host microseconds of a synchronised loop's step spans less
    the time each waited on the device (``wait_s``): the host's time to
    issue one step's work."""
    steps = named(run, name)
    if steps is None:
        return None
    return sum(s.end - s.start - s.attrs["wait_s"]
               for s in steps) / len(steps) * 1e6

