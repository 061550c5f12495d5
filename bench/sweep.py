#!/usr/bin/env python3
"""The knee of a serving cell: the highest query rate, with the cell's
writer running, at which the backlog does not grow.

    python3 bench/sweep.py --workload <name> --seed <n> \
        --rates 20,40,80 [--point-s 10] [--unpaced-epochs 8]

One set-up (the cell's store, server and RPC front on the card), then:
with an open-loop writer, first ``--unpaced-epochs`` unpaced steps with
no queries, whose median step time sets the writer's period (twice it);
then, with the writer running, one load-generator phase per rate in
ascending order (2 s of warm-up, ``--point-s`` measured). A rate is
sustained when every query due in its phase was answered within 2 s of
the phase's close and the median latency of its last third is within
twice that of its first third plus 20 ms. The sweep stops after the first
rate that is not. One JSON line per point; the benchmark's runs never
run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--point-s", type=float, default=10.0)
    ap.add_argument("--unpaced-epochs", type=int, default=8)
    ap.add_argument("--capacity-epochs", type=int, default=200)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import numpy as np
    import torch
    from repro_torch.kernels import _lib

    from benchlib import manifest as mf
    from benchlib import serve
    from benchlib.record import Run

    _lib.load()
    _, cfg, tr = mf.cell(mf.load(), args.workload)
    tr = copy.deepcopy(tr)
    run = Run(args.workload, cfg, tr, args.seed, args.point_s)
    cell = serve.Cell(run, torch.device("cuda"), args.capacity_epochs)
    cell.load_base()
    w = tr["writer"]
    if w["mode"] == "open":
        probe = serve.Writer(run, cell.server, cell.stream, cell.layout,
                             {"mode": "closed"})
        probe.start(time.monotonic())
        while len(run.spans) < args.unpaced_epochs and probe.error is None:
            time.sleep(0.2)
        probe.stop.set()
        probe.thread.join()
        steps = [e - s for name, s, e, _ in run.spans if name == "step"]
        median = statistics.median(steps)
        w["period_s"] = 2 * median
        print(json.dumps({"unpaced_step_s": steps, "median_s": median,
                          "period_s": w["period_s"]}), flush=True)
        writer = serve.Writer(run, cell.server, cell.stream, cell.layout, w)
        writer.t = probe.t
    else:
        writer = serve.Writer(run, cell.server, cell.stream, cell.layout, w)
    writer.start(time.monotonic())
    q = dict(tr["queries"], wait_s=2.0)
    for rate in (float(r) for r in args.rates.split(",")):
        q["rate_per_s"] = rate
        gen = cell.loadgen(q, args.seed + int(rate), 2.0, args.point_s)
        t0 = time.monotonic() + 0.5
        n0 = len(run.spans)
        serve.go(gen, t0)
        res = serve.collect(gen, args.point_s + 60)
        ok = res["state"] == 1
        lat = np.where(ok, res["recv"] - res["due"], np.inf) * 1e3
        third = max(1, len(lat) // 3)
        first = float(np.median(lat[:third]))
        last = float(np.median(lat[-third:]))
        steps = [e - s for name, s, e, _ in run.spans[n0:] if name == "step"]
        point = {"rate": rate, "queries": int(len(lat)),
                 "answered": int(ok.sum()),
                 "p50_ms": float(np.median(lat)),
                 "p99_ms": float(np.sort(lat)[max(0, int(np.ceil(
                     0.99 * len(lat))) - 1)]),
                 "first_third_p50_ms": first, "last_third_p50_ms": last,
                 "late_send_ms": float(np.max(res["sent"] - res["due"])
                                       * 1e3),
                 "steps": len(steps),
                 "step_s": statistics.median(steps) if steps else None,
                 "sustained": bool(ok.all() and last <= 2 * first + 20)}
        print(json.dumps(point), flush=True)
        if not point["sustained"]:
            break
    writer.stop.set()
    writer.thread.join()
    cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
