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

    python3 tools/profile_torch_serve.py --model [--out DIR]

profiles the model-serving slice instead (``chip_smoke.py`` phase 5:
full-width ``recurrentgemma-2b``, 8 requests of 4096 prompt tokens): after
one warm-up ``generate`` and one profiled warm-up prefill, one prefill
and then 16 decode steps, each under ``torch.profiler``, with their wall
time, device busy share, the kernels with the most device time and the
operators with the most host time, in ``DIR/model_profile.json``.
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


def profiled(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler: wall, device time and busy share,
    top kernels by device time, top operators by host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    averages = p.key_averages()
    # device-side events only (kernels, copies): an operator's own
    # device time repeats its kernels' and would count them twice
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"wall_s": wall, "device_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "top_device": [{"name": e.key[:120], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top],
            "top_host": [{"name": e.key[:80], "count": e.count,
                          "host_ms": e.self_cpu_time_total / 1e3}
                         for e in host]}


def profile_model(torch, cs, out: pathlib.Path) -> int:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as tf

    cfg = get_config(cs.MODEL_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    model = tf.init_params(cfg, gen, "cuda")
    prompts = np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (cs.MODEL_REQUESTS, cs.MODEL_PROMPT)) \
        .astype(np.int32)
    server = Server(cfg, model)
    server.generate(prompts, 2)                  # warm-up
    tokens = torch.from_numpy(prompts).cuda()
    steps = 16
    capacity = cs.MODEL_PROMPT + steps
    state = {}

    def prefill():
        with torch.inference_mode():
            state["logits"], state["cache"] = tf.prefill(
                model, cfg, tokens, capacity)

    def decode():
        with torch.inference_mode():
            tok = torch.argmax(state["logits"][:, -1], -1)[:, None]
            for t in range(steps):
                logits, state["cache"] = tf.decode_step(
                    model, cfg, state["cache"], tok, cs.MODEL_PROMPT + t)
                tok = torch.argmax(logits[:, 0], -1)[:, None]

    profiled(torch, prefill)     # the first window pays the profiler's start
    report = {"card": cs.device_line(), "arch": cs.MODEL_ARCH,
              "requests": cs.MODEL_REQUESTS, "prompt": cs.MODEL_PROMPT,
              "prefill": profiled(torch, prefill),
              "decode_steps": steps, "decode": profiled(torch, decode)}
    (out / "model_profile.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--model", action="store_true",
                    help="profile the model-serving slice instead")
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
    from repro_torch.nn.layers import strict_matmul
    strict_matmul()
    _lib.load()
    if args.model:
        return profile_model(torch, cs, out)
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

    report = {"card": cs.device_line(), "epochs": args.epochs,
              **profiled(torch, lambda: cs.serve_stream(torch, "cuda",
                                                        *shape))}
    (out / "device_profile.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
