#!/usr/bin/env python3
"""The control's and the planted faults' readings of a DeepSeek-V2
generation cell (driver ``generate_mla``), behind the upper end of each
limit.

    python3 bench/calibrate_mla.py --workload <name> --seeds 11,12,13 \
        [--seconds 1] [--faults causal_off,...|all]

``calibrate.py``'s model readings with this driver's faults: for each
seed, at the cell's own size and on the card, a whole run through
``harness.run_once`` with a window of ``--seconds`` (one call at least),
reading on the call it checks both the program's numbers and the
control's (``generate_mla.numbers`` with the reference rounded to
``CONTROL_BITS``, routing itself, in the program's place); then, on the
first seed, each fault of ``--faults`` (``benchlib/mla_moe_faults.py``)
planted in a run of its own. One JSON line per seed and per fault. The
benchmark's own runs never run this; the lower readings are those the
runs print.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch

    from benchlib import generate_mla, harness, mla_moe_faults
    from benchlib import manifest as mf

    if args.device == "cuda":
        from repro_torch.kernels import _lib

        _lib.load()
    manifest = mf.load()
    _, cfg, _ = mf.cell(manifest, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = (sorted(mla_moe_faults.FAULTS) if args.faults == "all"
              else [f for f in args.faults.split(",") if f])
    runs = [(seed, None) for seed in seeds] + [(seeds[0], f) for f in faults]
    for seed, fault in runs:
        t0 = time.monotonic()
        with (mla_moe_faults.FAULTS[fault]() if fault
              else contextlib.nullcontext()):
            run, _, correct, checks, state = harness.run_once(
                manifest, args.workload, seed, args.seconds,
                device=args.device, t_proc=t0)
        row = {"workload": args.workload, "seed": seed, "fault": fault,
               "correct": correct, "calls": run.attempted,
               "program": {k: c["value"] for k, c in checks.items()},
               "limits": {k: c["limit"] for k, c in checks.items()}}
        if fault is None:
            row["control"] = generate_mla.numbers(run, state, cfg, True)
        row["seconds"] = time.monotonic() - t0
        print(json.dumps(row), flush=True)
        del run, state
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
