#!/usr/bin/env python3
"""The batch of a generation cell: what one card holds, and what each
batch size yields.

    python3 bench/batch_sweep.py --workload <name> --seed <n> \
        --batches 16,32,48,64 [--calls 2] [--warm-gen 4]

One set-up (the cell's weights on the card, as a run draws them), then
for each batch in ascending order: one warm call of ``--warm-gen`` output
tokens, then ``--calls`` calls of the mix's prompt length and output
tokens, each with the run's own decode-step wrapper (``generate.Recorder``)
in place. One JSON line per call: its prefill and decode seconds, output
tokens a second, and the card's peak of allocated bytes over the batch.
The sweep stops at the first batch that runs out of memory. The
benchmark's own runs never run this.
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
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--warm-gen", type=int, default=4)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch
    from repro_torch.kernels import _lib

    from benchlib import generate, program
    from benchlib import manifest as mf

    _lib.load()
    _, cfg, tr = mf.cell(mf.load(), args.workload)
    device = torch.device("cuda")
    P, gen, vocab = tr["prompt_len"], tr["gen"], cfg["vocab_size"]
    t0 = time.monotonic()
    server = program.model_server(cfg, args.seed, device)
    decode = server.decode
    print(json.dumps({"weights_s": time.monotonic() - t0,
                      "weights_bytes": torch.cuda.memory_allocated()}),
          flush=True)
    for B in (int(b) for b in args.batches.split(",")):
        server.decode = decode
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = generate.checked_rows(args.seed, B, tr["checked_rows"])
        try:
            generate.Recorder(server, rows, P, gen, vocab, device)
            for call in range(args.calls + 1):
                n = args.warm_gen if call == 0 else gen
                s = time.monotonic()
                server.generate(generate.prompts(args.seed, call, B, P,
                                                 vocab), n)
                tm = server.timings
                print(json.dumps({
                    "batch": B, "call": call, "gen": n,
                    "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
                    "step_ms": 1e3 * tm["decode_s"] / n,
                    "tok_s": B * n / (time.monotonic() - s),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "reserved_bytes": torch.cuda.max_memory_reserved()}),
                    flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"batch": B, "out_of_memory": str(e)[:300]}),
                  flush=True)
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
