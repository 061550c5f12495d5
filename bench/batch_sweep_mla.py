#!/usr/bin/env python3
"""The batch of a DeepSeek-V2 generation cell (driver ``generate_mla``):
what one card holds, and what each batch size yields.

    python3 bench/batch_sweep_mla.py --workload <name> --seed <n> \
        --batches 8,16,24,32 [--calls 1] [--warm-gen 4]

``batch_sweep.py``'s sweep over the driver's server
(``generate_mla.model_server``) and decode-step wrapper
(``generate_mla.MLARecorder``, with the route hook installed): one
set-up, then for each batch in ascending order one warm call of
``--warm-gen`` output tokens and ``--calls`` calls of the mix's prompt
length and output tokens. One JSON line per call: its prefill and decode
seconds, output tokens a second, and the card's peaks of allocated and
reserved bytes over the batch. The sweep stops at the first batch that
runs out of memory. The benchmark's own runs never run this.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--warm-gen", type=int, default=4)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.nn import moe

    from benchlib import deepseek_v2_weights, generate, generate_mla
    from benchlib import manifest as mf

    _lib.load()
    _, cfg, tr = mf.cell(mf.load(), args.workload)
    device = torch.device("cuda")
    P, gen, vocab = tr["prompt_len"], tr["gen"], cfg["vocab_size"]
    s = deepseek_v2_weights.shape_of(cfg)
    t0 = time.monotonic()
    server = generate_mla.model_server(cfg, args.seed, device)
    decode = server.decode
    moes = [m for m in server.params.modules() if isinstance(m, moe.MoE)]
    print(json.dumps({"weights_s": time.monotonic() - t0,
                      "weights_bytes": torch.cuda.memory_allocated()}),
          flush=True)
    for B in (int(b) for b in args.batches.split(",")):
        server.decode = decode
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = generate.checked_rows(args.seed, B, tr["checked_rows"])
        try:
            routes = generate_mla.Routes(rows, len(moes), s["dense"],
                                         P + gen, s["k"], device)
            moe.install_route_hook(server.params, routes)
            generate_mla.MLARecorder(server, rows, P, gen, vocab, device,
                                     routes, moes)
            for call in range(args.calls + 1):
                n = args.warm_gen if call == 0 else gen
                routes.pos = 0
                s0 = time.monotonic()
                server.generate(generate.prompts(args.seed, call, B, P,
                                                 vocab), n)
                tm = server.timings
                print(json.dumps({
                    "batch": B, "call": call, "gen": n,
                    "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
                    "step_ms": 1e3 * tm["decode_s"] / n,
                    "tok_s": B * n / (time.monotonic() - s0),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "reserved_bytes": torch.cuda.max_memory_reserved()}),
                    flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"batch": B, "out_of_memory": str(e)[:300]}),
                  flush=True)
            break
        finally:
            moe.install_route_hook(server.params, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
