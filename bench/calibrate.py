#!/usr/bin/env python3
"""The control's readings, behind the upper end of each limit.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--versions 4] [--seconds 1] [--faults causal_off,...]

For each seed, at the cell's own size and on the card: the reference put
in the program's place one precision below the configuration's (bfloat16
for float32), at the first ``--versions`` stream versions the cell
serves, read as the check reads the program (``benchlib/check.py``):
the served top-8 PageRank's worst relative gap and the in-degree top-8's
mismatches (serving cells), or the ranks' L1 distance from float64 (the
timeline). One JSON line per seed and version.

A generation cell (driver ``generate``) instead runs whole through
``harness.run_once`` with a window of ``--seconds`` (one call at least),
and reads on the call it checks both the program's numbers and the
control's (``generate.numbers`` with the reference rounded to
``CONTROL_BITS`` in the program's place); then, on the first seed, each
fault of ``--faults`` (``benchlib/model_faults.py``) planted in a run of
its own. One JSON line per seed and per fault. The benchmark's own runs
never run this; the lower readings are those the runs print.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--versions", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench")]
    import numpy as np
    import torch

    from benchlib import check
    from benchlib import manifest as mf
    from benchlib.reference import live_graph
    from benchlib.stream import KroneckerStream, Layout

    _, cfg, tr = mf.cell(mf.load(), args.workload)
    if tr["driver"] == "generate":
        return model_readings(args)
    blocks = (tr["writer"]["epoch_blocks"] if tr["driver"] == "serve"
              else tr["epoch_blocks"])
    layout = Layout(cfg["base_blocks"], cfg["base_epochs"], blocks)
    ref_kw = cfg["reference_pagerank"]
    for seed in (int(s) for s in args.seeds.split(",")):
        stream = KroneckerStream(cfg["generator"], cfg["block_edges"], seed,
                                 args.device, keep=layout.base_blocks
                                 + layout.epoch_blocks)
        for t in range(1, args.versions + 1):
            t0 = time.monotonic()
            epoch = layout.epoch_of_stream(t)
            g = live_graph(stream, layout, epoch)
            ref, ref_it = g.pagerank(**ref_kw)
            low, low_it = g.pagerank(dtype=check.CONTROL_DTYPE, tol=1e-6,
                                     max_iter=200)
            f32, f32_it = g.pagerank(dtype=torch.float32, tol=1e-6,
                                     max_iter=200)
            row = {"workload": args.workload, "seed": seed, "epoch": epoch,
                   "m": g.m, "ref_iterations": ref_it,
                   "control_iterations": low_it,
                   "control_pagerank_l1": float((low.double() - ref)
                                                .abs().sum()),
                   "f32_reference_pagerank_l1": float((f32.double() - ref)
                                                      .abs().sum())}
            ref_np = ref.cpu().numpy()
            for name, ranks in (("control", low), ("f32_reference", f32)):
                ids, got = check._topk_ranks(ranks, 8)
                rel = np.abs(got.astype(np.float64) - ref_np[ids]) \
                    / ref_np[ids]
                row[f"{name}_pagerank_topk_rel"] = float(rel.max())
            ids, degs = g.degree_topk(8)
            c_ids, c_degs = check._control_topk(g, 8)
            row["control_topk_mismatch"] = int(
                (c_ids != ids).sum() + (c_degs.double() != degs.double())
                .sum())
            row["seconds"] = time.monotonic() - t0
            print(json.dumps(row), flush=True)
            del g
    return 0


def model_readings(args) -> int:
    import contextlib
    import gc

    import torch

    sys.path.insert(1, str(ROOT / "src"))
    from benchlib import generate, harness, model_faults
    from benchlib import manifest as mf

    if args.device == "cuda":
        from repro_torch.kernels import _lib

        _lib.load()
    manifest = mf.load()
    _, cfg, _ = mf.cell(manifest, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(seed, None) for seed in seeds] + [
        (seeds[0], f) for f in args.faults.split(",") if f]
    for seed, fault in runs:
        t0 = time.monotonic()
        with (model_faults.FAULTS[fault]() if fault
              else contextlib.nullcontext()):
            run, _, correct, checks, state = harness.run_once(
                manifest, args.workload, seed, args.seconds,
                device=args.device, t_proc=t0)
        row = {"workload": args.workload, "seed": seed, "fault": fault,
               "correct": correct, "calls": run.attempted,
               "program": {k: c["value"] for k, c in checks.items()},
               "limits": {k: c["limit"] for k, c in checks.items()}}
        if fault is None:
            row["control"] = generate.numbers(run, state, cfg, True)
        row["seconds"] = time.monotonic() - t0
        print(json.dumps(row), flush=True)
        del run, state
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
