"""A kernel's share of its roofline from the trace.

Each kernel's count of the work its inputs need sits in a file of its own,
``bench/roofline/<kernel>.py``: ``KERNEL_NAMES`` (substrings of the device
kernel names that are its launches), ``flops(**shape)`` and
``bytes_moved(**shape)``. The least time a launch can take is the larger
of its operations over the card's peak rate and its bytes over the peak
bandwidth (``PEAKS``). The share is the bound of the launches the
profiler recorded over their recorded device time: the calls the harness
made inside the traced sub-window give the shapes, and a launch the
profiler dropped is left out of both sides.
"""
from __future__ import annotations

import importlib.util
import pathlib
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "flops_per_s": {"float32": 67e12,
                                                      "tf32": 495e12,
                                                      "bfloat16": 989e12}}


def load_count(kernel: str):
    path = ROOT / "roofline" / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_s(mod, shape: dict) -> float:
    rate = PEAKS["flops_per_s"][shape.get("dtype", "float32")]
    return max(mod.flops(**shape) / rate,
               mod.bytes_moved(**shape) / PEAKS["hbm_bytes_per_s"])


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    tr = run.trace
    if not tr:
        return None
    mod = load_count(kernel)
    t0, t1 = tr["t0"], tr["t1"]
    calls = [(n, shape) for s, e, k, n, shape in run.kernel_calls
             if k == kernel and t0 <= s and e <= t1]
    launches = sum(n for n, _ in calls)
    if not launches:
        return None
    mean_bound = sum(n * bound_s(mod, shape) for n, shape in calls) / launches
    seen = [v for name, v in tr["kernels"].items()
            if any(k in name for k in mod.KERNEL_NAMES)]
    count = sum(c for c, _ in seen)
    seconds = sum(s for _, s in seen)
    if not count or seconds <= 0:
        return None
    return 100.0 * count * mean_bound / seconds
