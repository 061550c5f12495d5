#!/usr/bin/env python3
"""Where the PyTorch port's serving slice spends its time on one CUDA card.

    python3 tools/profile_torch_serve.py [--epochs 16] [--out DIR]

(``DIR`` defaults to ``build/profile`` at the repository root.)

Runs the slice ``chip_smoke.py`` drives (1,048,576 vertices, 4 shards,
1,000,000 adds per epoch, ``delete_frac=0.2``, 16 demo queries per epoch)
twice on the card:

1. under ``cProfile``: the host functions with the most cumulative time,
   by module, as text in ``DIR/host_profile.txt``;
2. under ``torch.profiler`` (CPU and CUDA activities): the device time
   summed over all kernels against the run's wall time (the device's busy
   share), and the kernels with the most device time, in
   ``DIR/device_profile.json``.

Prints a summary of both. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pathlib
import pstats
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--out", type=str,
                    default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    from repro_torch.kernels import _lib
    _lib.load()
    shape = (cs.N_VERTICES, args.epochs, cs.ADDS_PER_EPOCH)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    cs.serve_stream(torch, "cuda", *shape)
    prof.disable()
    host_wall = time.perf_counter() - t0
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text).sort_stats("cumulative")
    stats.print_stats(60)
    (out / "host_profile.txt").write_text(text.getvalue())
    print(f"host profile: wall {host_wall:.3f} s; top cumulative:")
    rows = sorted(((v[3], f"{pathlib.Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in stats.stats.items()
                   if "repro_torch" in k[0] or "numpy" in k[0]),
                  reverse=True)
    for cum, name in rows[:30]:
        print(f"  {cum:9.3f} s  {name}")

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        cs.serve_stream(torch, "cuda", *shape)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): an operator's own
    # device time repeats its kernels' and would count them twice
    events = [e for e in p.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    report = {
        "card": cs.device_line(), "epochs": args.epochs,
        "wall_s": wall, "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "top_device": [{"name": e.key[:120], "count": e.count,
                        "device_ms": e.self_device_time_total / 1e3}
                       for e in top]}
    (out / "device_profile.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
