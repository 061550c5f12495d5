"""One run of a cell, from its set-up to the checked result.

``run.py`` calls :func:`run_once` on the card; the CPU tests call it at a
tiny size with ``device="cpu"`` (no trace), with faults planted in the
program underneath, to see ``correct`` fail.

A traffic mix names its driver, ``bench/benchlib/<driver>.py``, which is
all a run needs of the cell's kind: ``run_cell(run, device, t_proc,
trace_window)`` drives the set-up and the window and returns what the
check needs once the program's state is freed, and ``numbers(run, state,
config, control)`` returns the numbers compared against the
configuration's ``limits``.
"""
from __future__ import annotations

import gc
import importlib

import torch

from benchlib import check
from benchlib import manifest as mf
from benchlib.record import Run


def run_once(manifest: dict, workload: str, seed: int, seconds: float, *,
             trace_window=None, device=None, t_proc: float,
             config: dict | None = None, traffic: dict | None = None,
             control: bool = False) -> tuple[Run, dict, bool, dict, dict]:
    """(run record, metrics, correct, checks, program state summary).
    ``config`` / ``traffic`` replace the cell's files (the tests' tiny
    sizes); ``control`` puts the lower-precision reference in the
    program's place for the compared floating-point answers."""
    cell, cfg, tr = mf.cell(manifest, workload)
    cfg = config or cfg
    tr = traffic or tr
    device = torch.device(device or "cuda")
    run = Run(workload, cfg, tr, seed, seconds)
    driver = importlib.import_module(f"benchlib.{tr['driver']}")
    if trace_window is not None:
        trace_window.prime()
    state = driver.run_cell(run, device, t_proc, trace_window)
    if trace_window is not None:
        run.trace = trace_window.summary(run.spans)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.numbers(run, state, cfg, control)
    correct, checks = check.judge(numbers, cfg["limits"])
    metrics = {}
    for m in mf.metrics_for(manifest, workload, trace_window is not None):
        value = mf.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return run, metrics, correct, checks, state
