#!/usr/bin/env python3
"""Two readings behind ``chip_smoke.py`` phase 9, on one CUDA card.

    python3 tools/probe_phase9.py [--out FILE] [--arch ARCH ...]

(``FILE`` defaults to ``build/probe_phase9.jsonl`` at the repository
root.) Runs ``chip_smoke.py``'s phases 1-8 as they are, then, in place of
phase 9, appends one JSON record a line to ``FILE``:

1. the profiler's record loss late in a run: at every attention shape
   phase 9 launches, the row ``flash_attention_case`` gives, then windows
   of 5, 1 and 20 calls (CUDA activity alone, with CPU activity, with a
   50 ms wait before or after the calls), each with the device records
   the profiler kept and the host launches it saw, and the kernel's time
   from CUDA events over 20 calls queued behind a spin;
2. for each phase 9 model at its phase 9 size, the whole prefill against
   the plain route: the kernel route's and that of
   ``chip_smoke.rounded_p_attention`` with P kept to 8, 7, 6, 5 and 4
   significant bits (worst tensor, its error, the logits' error).

With ``--arch`` (repeatable; a model of ``chip_smoke.FAMILY_RUNS``) it
builds the kernels and takes reading 2 alone for those models, with no
earlier phase and no profiler windows.
"""
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
OUT = ROOT / "build" / "probe_phase9.jsonl"


def emit(rec):
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("probe " + json.dumps(rec)[:600], flush=True)


def window(torch, fn, reps, cpu=False, lead=0.0, tail=0.0):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter_ns()
    with profile(activities=acts) as prof:
        h1 = time.perf_counter_ns()
        if lead:
            time.sleep(lead)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if tail:
            time.sleep(tail)
        h2 = time.perf_counter_ns()
    h3 = time.perf_counter_ns()
    kr = prof.profiler.kineto_results
    ts = kr.trace_start_ns()
    dev, launch = [], []
    for e in kr.events():
        dt = str(e.device_type())
        if "CUDA" in dt:
            dev.append((e.name()[:30], (e.start_ns() - ts) / 1e3,
                        (e.end_ns() - ts) / 1e3))
        elif "aunch" in e.name():
            launch.append((e.name()[:24], (e.start_ns() - ts) / 1e3))
    ka = [(e.key[:30], e.count, e.self_device_time_total)
          for e in prof.key_averages() if e.self_device_time_total > 0]
    return {"n_dev": len(dev), "dev": dev[:8], "n_launch": len(launch),
            "launch": launch[:8], "ka": ka,
            "host_us": [(h1 - h0) / 1e3, (h2 - h1) / 1e3, (h3 - h2) / 1e3]}


def queued_ms(torch, fn, n=20):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def diag_shapes(torch):
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED + 9)
    shapes = []
    for arch, layers, requests in cs.FAMILY_RUNS:
        for key in cs.family_attention_shapes(cs.family_config(arch, layers),
                                              requests):
            if key not in shapes:
                shapes.append(key)
    real_dev = cs.device_ms
    for key in shapes:
        B, Hq, Hkv, S, hd, win = key
        got = {}

        def rec_dev(*a, **k):
            got["dev"] = real_dev(*a, **k)
            return got["dev"]
        cs.device_ms = rec_dev
        row = cs.flash_attention_case(torch, g, (B, Hq, Hkv, S, hd),
                                      torch.bfloat16, win, 1e-2)
        cs.device_ms = real_dev
        emit({"shape": key, "case_dev": got["dev"], "ms": row["ms"]})
        q, k, v = (torch.randn((B, h, S, hd), generator=g, device="cuda")
                   .bfloat16() for h in (Hq, Hkv, Hkv))

        def fn():
            return ops.flash_attention(q, k, v, window=win, use_kernel=True)
        for name, kw in (("as_is", dict(reps=5)),
                         ("cpu", dict(reps=5, cpu=True)),
                         ("tail50ms", dict(reps=5, tail=0.05)),
                         ("lead50ms", dict(reps=5, lead=0.05)),
                         ("reps1", dict(reps=1)),
                         ("reps20", dict(reps=20)),
                         ("as_is_again", dict(reps=5))):
            for trial in range(2):
                emit({"shape": key, "variant": name, "trial": trial,
                      **window(torch, fn, **kw)})
        emit({"shape": key, "queued_ms": [queued_ms(torch, fn)
                                          for _ in range(3)]})
        del q, k, v
        torch.cuda.empty_cache()


def readings(torch, archs=None):
    import gc

    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    for arch, layers, requests in cs.FAMILY_RUNS:
        if archs is not None and arch not in archs:
            continue
        cfg = cs.family_config(arch, layers)
        g = torch.Generator(device="cuda")
        g.manual_seed(cs.SEED)
        model = tf.init_params(cfg, g, "cuda")
        rng = np.random.default_rng(cs.SEED)
        P = cs.FAMILY_PROMPT
        if cfg.embed_mode == "frames":
            x = rng.standard_normal((requests, P, cfg.d_model)).astype(
                np.float32)
        else:
            x = rng.integers(0, cfg.vocab_size, (requests, P)).astype(
                np.int32)
        x = torch.from_numpy(x).cuda()
        cap = P + cs.FAMILY_GEN
        rec = {"arch": arch, "layers": cfg.num_layers}
        t = time.perf_counter()
        with torch.inference_mode():
            plain = tf.prefill(model, cfg, x, cap, use_kernel=False)
            kern = tf.prefill(model, cfg, x, cap)
            e = cs.prefill_errors(torch, cfg, kern, plain)
            w = max(e, key=e.get)
            rec["kernel"] = [w, e[w], e["logits"]]
            del kern
            real = ops.flash_attention
            for bits in (8, 7, 6, 5, 4):
                ops.flash_attention = cs.rounded_p_attention(torch, bits)
                try:
                    alt = tf.prefill(model, cfg, x, cap)
                finally:
                    ops.flash_attention = real
                e = cs.prefill_errors(torch, cfg, alt, plain)
                w = max(e, key=e.get)
                rec[f"p{bits}"] = [w, e[w], e["logits"]]
                del alt
                torch.cuda.synchronize()
        rec["s"] = time.perf_counter() - t
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        emit(rec)
        del model, plain, x
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase9(torch, rows):
    t = time.perf_counter()
    diag_shapes(torch)
    print(f"diag shapes {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    readings(torch)
    print(f"readings {time.perf_counter() - t:.1f} s", flush=True)


cs.serve_families = phase9
if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    ap.add_argument("--arch", action="append", default=None,
                    help="take the prefill readings of this model alone")
    args = ap.parse_args()
    OUT = args.out.resolve()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    if args.arch is None:
        sys.exit(cs.main())
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.nn.layers import strict_matmul
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    strict_matmul()
    print(cs.device_line(), flush=True)
    _lib.load()
    t = time.perf_counter()
    readings(torch, set(args.arch))
    print(f"readings {time.perf_counter() - t:.1f} s", flush=True)
