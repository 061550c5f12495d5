"""The temporal analytics cell: PageRank and WCC over a run of versions.

Set-up loads the base and ``stream_epochs`` stream epochs through the
store's ``apply``, builds each stream version's view through the store's
public ``join_view`` and runs one whole pass untimed, so every shape and
view is warm. In the window, pass after pass, each version in order is
taken through ``join_view``, then ``graph.compute.pagerank`` (warm-started
from the previous version's ranks within a pass, cold at its first
version) and ``graph.compute.wcc``. Every pass computes the same answers,
so the check compares the last finished pass's.
"""
from __future__ import annotations

import time

import torch

from benchlib import check, program
from benchlib.stream import KroneckerStream


def run_cell(run, device, t_proc: float, trace_window=None) -> dict:
    from repro_torch.core.versioned import Version
    from repro_torch.graph import compute as gc

    cfg, tr = run.config, run.traffic
    layout = program.layout_of(cfg, tr["epoch_blocks"])
    stream = KroneckerStream(cfg["generator"], cfg["block_edges"], run.seed,
                             device, keep=layout.base_blocks
                             + layout.epoch_blocks)
    e_max = program.edge_capacity(cfg, layout, tr["stream_epochs"])
    sg = program.build_store(cfg, e_max, device)
    last = layout.base_epochs + tr["stream_epochs"]
    for e in range(last):
        sg.apply(program.mutation_batch(stream, layout, e))
    epochs = list(range(layout.base_epochs, last))
    versions = [Version(e, 0) for e in epochs]
    sizes = [sg.num_vertices(v) + sg.join_view(v).m for v in versions]
    kw = tr["pagerank"]
    results: dict[int, dict] = {}

    def one_pass(spans: bool, t_end: float | None) -> bool:
        prev = None
        for epoch, v, size in zip(epochs, versions, sizes, strict=True):
            t0 = time.monotonic()
            view = sg.join_view(v)
            t1 = time.monotonic()
            pr = gc.pagerank(view, init=None if prev is None else prev.ranks,
                             **kw)
            t2 = time.monotonic()
            labels = gc.wcc(view, max_rounds=tr["wcc_max_rounds"])
            t3 = time.monotonic()
            prev = pr
            if spans:
                run.spans += [("join_view", t0, t1, {"epoch": epoch}),
                              ("pagerank", t1, t2,
                               {"epoch": epoch, "iterations": pr.iterations}),
                              ("wcc", t2, t3, {"epoch": epoch})]
                run.kernel_calls.append((t1, t2, "segment_sum",
                                         pr.iterations,
                                         {"m": view.m, "n": view.n, "f": 1}))
            if t_end is not None and t3 > t_end:
                return False
            results[epoch] = {"ranks": pr.ranks, "labels": labels,
                              "iterations": pr.iterations}
            if spans:
                run.done_versions.append((t3, size))
        return True

    one_pass(False, None)
    run.t_open = time.monotonic()
    run.t_close = run.t_open + run.seconds
    run.setup_s = run.t_open - t_proc
    while True:
        now = time.monotonic()
        if trace_window is not None:
            if trace_window.t0 is None and \
                    now >= run.t_open + tr["trace_offset_s"]:
                trace_window.start()
            elif trace_window.t0 is not None and trace_window.t1 is None \
                    and now >= trace_window.t0 + tr["trace_s"]:
                trace_window.stop()
        if not one_pass(True, run.t_close):
            break
    if trace_window is not None and trace_window.t0 is not None \
            and trace_window.t1 is None:
        trace_window.stop()
    run.attempted = len(run.done_versions)
    run.failed = 0
    for epoch, v in zip(epochs, versions, strict=True):
        results[epoch]["digest"] = program.digest_of(sg.join_view(v)).tolist()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    sg.shutdown()
    del sg
    return {"stream": stream, "layout": layout, "results": results,
            "memory_peak_bytes": peak}


def numbers(run, state: dict, config: dict, control: bool) -> dict:
    """The timeline cell's compared numbers (``check.timeline_numbers``)."""
    return check.timeline_numbers(state["results"], state["stream"],
                                  state["layout"],
                                  config["reference_pagerank"],
                                  control=control)
