#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/probe_phase13.py

Builds the kernels, then runs phase 13, the elastic and durable graph
plane (``chip_smoke.elastic_plane``), with every check the smoke run
holds. Its lines are printed as each part ends, so the readings behind
``PLANE_PAGERANK_RTOL`` are on 13a's line even when that limit fails:
each kernel PageRank run's largest per-vertex relative error against a
float64 rerun from the same start, and the control's (the run on the
largest view again with its contributions kept to bf16). The
write-ahead logs go under ``build/probe_phase13/`` and are removed at the
end.

It prints no ``ok`` line: it is not a smoke run.
"""
import importlib.util
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from repro_torch.kernels import _lib

    card = cs.device_line()
    t = time.perf_counter()
    _lib.load()
    cs.log(f"build: {time.perf_counter() - t:.3f} s [{card}]")
    t = time.perf_counter()
    try:
        cs.elastic_plane(torch, workdir=ROOT / "build" / "probe_phase13",
                         card=card)
    except cs.SmokeFailure as exc:
        print(f"probe_phase13: FAIL: {exc}", file=sys.stderr, flush=True)
        return 1
    cs.log(f"phase 13 alone: {time.perf_counter() - t:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
