#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 11's whole-model limits, on
one CUDA card.

    python3 tools/probe_phase11.py [--out FILE]

(``FILE`` defaults to ``build/probe_phase11.jsonl`` at the repository
root.) Serves xlstm-1.3b as phase 11 does (``chip_smoke.serve_model``, 2 x
1024 prompt tokens on the scan route), then appends one JSON record a
line to ``FILE``:

1. the whole prefill against the scan route's, per layer (the worst of
   each layer's states) and for the logits, on: the chunkwise route at
   chunk 64 and 32 and the scan route with every mixer's float32
   arithmetic in float64 (sound routes), and the scan route with each
   mixer's output kept to 6, 5 and 4 significant bits (controls);
2. layer by layer, each mixer fed the scan route's input: the chunkwise
   routes and the float64 arithmetic against the scan route;
3. continuity (``chip_smoke.xlstm_continuity_readings``) at prompts of
   128, 256 and 512 and 32 decode steps: the whole model and layer by
   layer, with palindromic kernels, with the conv rounding removed, the
   decode's outputs kept to 4 bits (the control), the unshifted conv
   state and the random kernels.

``--only continuity`` takes part 3 alone (about a minute after the
serving run).

It builds no kernel (the family has none) and prints no ``ok`` line: it
is not a smoke run.
"""
import argparse
import copy
import dataclasses
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
OUT = ROOT / "build" / "probe_phase11.jsonl"
BITS = (6, 5, 4)
CONT_PROMPTS = (128, 256, 512)


def emit(rec):
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("probe " + json.dumps(rec)[:3000], flush=True)


class outputs_to_bits:
    """Within ``with``, each xLSTM mixer's output is kept to ``bits``
    significant bits (a control: bf16 keeps 8)."""

    def __init__(self, torch, bits: int):
        from repro_torch.nn import recurrent as rec
        self.torch, self.rec, self.bits = torch, rec, bits

    def __enter__(self):
        self.real = {k: getattr(self.rec, f"{k}_forward")
                     for k in ("mlstm", "slstm")}
        for kind, fwd in self.real.items():
            def rounded(p, x, cfg, return_state=False, fwd=fwd):
                out = fwd(p, x, cfg, return_state=return_state)
                y = out[0] if return_state else out
                y = cs.round_to_bits(self.torch, y.float(), self.bits).to(
                    y.dtype)
                return (y, out[1]) if return_state else y
            setattr(self.rec, f"{kind}_forward", rounded)
        return self

    def __exit__(self, *exc):
        for kind, fwd in self.real.items():
            setattr(self.rec, f"{kind}_forward", fwd)


def per_layer_worst(cfg, errs: dict) -> dict:
    """{"logits": .., "layers": [worst state of each layer]}."""
    n = cfg.num_layers
    return {"logits": errs["logits"],
            "layers": [max(v for k, v in errs.items()
                           if k.startswith(f"layer{i}.")) for i in range(n)]}


def readings(torch, only=None):
    from repro_torch.models import transformer as tf

    cfg = cs.xlstm_config()
    t = time.perf_counter()
    run = cs.serve_model(torch, cfg, requests=cs.XLSTM_REQUESTS,
                         prompt=cs.XLSTM_PROMPT, gen=cs.XLSTM_GEN)
    emit({"serve_s": time.perf_counter() - t, "timings": run["timings"]})
    if only != "continuity":
        route_readings(torch, tf, cfg, run)
    for prompt in CONT_PROMPTS:
        t = time.perf_counter()
        r = cs.xlstm_continuity_readings(torch, run, prompt, cs.XLSTM_GEN)
        r["whole"] = per_layer_worst(cfg, r["whole"])
        emit({"continuity": prompt, "s": time.perf_counter() - t, **r})


def route_readings(torch, tf, cfg, run):
    model = run["model"]
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    routes = {f"chunkwise {c}": dataclasses.replace(
        cfg, mlstm_impl="chunkwise", mlstm_chunk=c) for c in (64, 32)}
    r = cs.xlstm_route_readings(torch, run, routes)
    scan = r["scan"]
    whole = {n: per_layer_worst(cfg, e) for n, e in r["whole"].items()}
    with torch.inference_mode():
        for bits in BITS:
            with outputs_to_bits(torch, bits):
                other = tf.prefill(model, cfg, prompts)
            whole[f"outputs to {bits} bits"] = per_layer_worst(
                cfg, cs.prefill_errors(torch, cfg, other, scan))
        emit({"whole": whole})
        per_layer = dict(r["per_layer"], float64=[])
        for k, p, h, want in r["calls"]:
            p64 = copy.deepcopy(p).double()
            per_layer["float64"].append(cs.mixer_errors(
                torch, cs.xlstm_mixer(k)[0](p64, h, cfg, return_state=True),
                want))
            del p64
        emit({"per_layer": per_layer})
        del r
        model64 = copy.deepcopy(model).double()
        whole = {"float64": per_layer_worst(cfg, cs.prefill_errors(
            torch, cfg, tf.prefill(model64, cfg, prompts), scan))}
        del model64
        torch.cuda.empty_cache()
        emit({"whole": whole})


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--only", choices=["continuity"], default=None)
    args = ap.parse_args()
    OUT = pathlib.Path(args.out)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from repro_torch.nn.layers import strict_matmul

    strict_matmul()
    emit({"device": cs.device_line()})
    t = time.perf_counter()
    readings(torch, args.only)
    emit({"probe_s": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
