"""What one run leaves for the metric readers, and the readers' helpers.

A reader (``bench/metrics/<metric>.py``) is a module with ``read(run)``
that returns the metric's value or None when the run holds nothing for
it; the harness then leaves the metric out of the line. Readers work
only from this record: the harness's own spans and clocks, the counters
it sampled from the program at the window's open and close, the load
generator's per-query times, and the trace's summary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    setup_s: float = 0.0
    t_open: float = 0.0                 # time.monotonic() of the window
    t_close: float = 0.0
    # (name, start, end, attributes) from the harness's wrappers
    spans: list = dataclasses.field(default_factory=list)
    # (time, packed version, digest) per published snapshot
    publishes: list = dataclasses.field(default_factory=list)
    epoch_mutations: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)   # open/close
    queries: Optional[dict] = None      # the load generator's arrays
    wait_s: float = 0.0
    done_versions: list = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None
    # (start, end, kernel, launches, shape) per call the harness made
    kernel_calls: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    notes: list = dataclasses.field(default_factory=list)

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def delta(self, key: str) -> Optional[float]:
        a = self.counters.get("open", {}).get(key)
        b = self.counters.get("close", {}).get(key)
        if a is None or b is None:
            return None
        return b - a

    def window_spans(self, name: str) -> list:
        """Spans of ``name`` that ended inside the window."""
        return [s for s in self.spans
                if s[0] == name and self.t_open <= s[2] <= self.t_close]


def nearest_rank(values, q: float) -> Optional[float]:
    """The ``q``-th percentile by nearest rank (no interpolation, so a
    tail is a sample that was seen)."""
    v = np.sort(np.asarray(values, np.float64))
    if not v.size:
        return None
    i = max(0, math.ceil(q / 100.0 * v.size) - 1)
    return float(v[i])


def client_latencies_ms(run: Run) -> Optional[np.ndarray]:
    """Each window query's latency at the client, from its due time to its
    answer, in ms. A query that failed, was shed or never came counts as
    slower than every answered one: it takes the whole span from the
    window's open to the end of the wait, plus a millisecond."""
    q = run.queries
    if q is None or not len(q["due"]):
        return None
    lat = (q["recv"] - q["due"]) * 1e3
    worst = (run.t_close + run.wait_s - run.t_open) * 1e3 + 1.0
    return np.where(q["state"] == 1, lat, worst)


def answered(run: Run) -> Optional[np.ndarray]:
    q = run.queries
    if q is None:
        return None
    ok = q["state"] == 1
    return ok if ok.any() else None


def ratio_pct(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if num is None or den is None or den <= 0:
        return None
    return 100.0 * num / den


def device_idle_pct(run: Run) -> Optional[float]:
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
