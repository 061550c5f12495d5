"""The generation cells' calls, for the metric readers: the harness's
``generate`` spans (one a ``Server.generate`` call, with its batch,
prompt and output lengths and the server's ``prefill_s`` and
``decode_s``) that ended inside the window, but for the one call a traced
run runs under the profiler, whose host times the profiler stretches."""
from __future__ import annotations

import statistics
from typing import Optional


def window_calls(run) -> list:
    """(start, end, attributes) of the calls that finished in the
    window with the profiler off."""
    return [(s, e, a) for _, s, e, a in run.window_spans("generate")
            if not a["traced"]]


def median_of(run, value) -> Optional[float]:
    """The median over the window's calls of ``value(start, end,
    attributes)``, or None without calls."""
    calls = window_calls(run)
    if not calls:
        return None
    return statistics.median(value(s, e, a) for s, e, a in calls)
