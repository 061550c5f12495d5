#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
metric readers and roofline counts are the files ``BENCHMARK.json``
names (see ``benchlib/manifest.py``). The run builds the cell's inputs
from ``--seed``, sets up and warms every shape the cell uses, measures
for ``--seconds``, then, with the program's state freed, checks what the
timed path produced against the plain reference (the driver's
``numbers``, each held to its limit by ``benchlib/check.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, read from a profiled sub-window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also the last lines of
standard error.

It exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), when the program cannot be imported, or
when JAX or the JAX package was loaded into this process. Kernel builds
and caches stay inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    from benchlib import manifest as mf

    manifest = mf.load()
    cell, config, traffic = mf.cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    from repro_torch.kernels import _lib

    from benchlib.harness import run_once
    from benchlib.trace import TraceWindow

    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)
    _lib.load()
    tw = TraceWindow(torch) if args.trace else None
    run, metrics, correct, checks, state = run_once(
        manifest, args.workload, args.seed, args.seconds, trace_window=tw,
        t_proc=T_PROC)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 5
    device_out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"],
                  "memory_peak_bytes": int(state["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_out,
           "card": card, "notes": run.notes}
    if run.trace is not None:
        device_out["busy_s"] = run.trace["busy_s"]
        device_out["window_s"] = run.trace["window_s"]
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
