#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 10's limits, on one CUDA card.

    python3 tools/probe_phase10.py [--out FILE]

(``FILE`` defaults to ``build/probe_phase10.jsonl`` at the repository
root.) Builds the kernels, then for each of ``chip_smoke.MOE_RUNS`` at its
phase 10 size (served once through ``chip_smoke.serve_model``) appends one
JSON record a line to ``FILE``:

1. ``chip_smoke.check_moe_layer`` (its own checks held; its timing windows
   exercise ``primed_profile``);
2. the routing layer by layer (``chip_smoke.routing_layer_flips``): the
   flip shares of the kernel, the sound route and the bf16 router, which
   set ``BF16_ROUTER_FLIPS``;
3. the whole prefill against the plain route
   (``chip_smoke.moe_prefill_readings``, no limit held) on the dense
   dispatch, and on ``MOE_DROPPING_ARCH`` on the dropping one: as it runs,
   with the plain route's routing replayed, every planted fault, and P kept
   to 8, 7, 6, 5 and 4 significant bits; these set ``MOE_PREFILL_RTOL``.

It prints no ``ok`` line: it is not a smoke run.
"""
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
OUT = ROOT / "build" / "probe_phase10.jsonl"
BITS = (8, 7, 6, 5, 4)


def emit(rec):
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("probe " + json.dumps(rec)[:3000], flush=True)


def readings(torch):
    for arch, layers, requests, prompt in cs.MOE_RUNS:
        t = time.perf_counter()
        cfg = cs.family_config(arch, layers)
        run = cs.serve_model(torch, cfg, requests=requests, prompt=prompt,
                             gen=cs.MOE_GEN)
        emit({"arch": arch, "moe_layer": cs.check_moe_layer(torch, run)})
        emit({"arch": arch, "routing": cs.routing_layer_flips(torch, run)})
        cfgs = [cfg]
        if arch == cs.MOE_DROPPING_ARCH:
            cfgs.append(dataclasses.replace(
                cfg, moe_impl="dropping", capacity_factor=cs.MOE_CAPACITY))
        for c in cfgs:
            emit({"arch": arch, "prefill": cs.moe_prefill_readings(
                torch, run, c, cs.moe_prefill_variants(torch, c, BITS))})
        emit({"arch": arch, "s": time.perf_counter() - t,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from repro_torch.kernels import _lib
    from repro_torch.nn.layers import strict_matmul

    strict_matmul()
    print(cs.device_line(), flush=True)
    t = time.perf_counter()
    _lib.load()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    readings(torch)
    print(f"readings {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    OUT = ap.parse_args().out.resolve()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    sys.exit(main())
