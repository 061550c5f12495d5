"""Batched serving example on the PyTorch port: prefill + KV-cache decode
for several archs, including a recurrent-state arch (no KV growth) — the
long-context serving path that motivates the long_500k cell — with the
weights, caches and kernels on ``--device``.

    PYTHONPATH=src python examples/torch_serve_batched.py

Each model is the reduced config of its arch with random weights from
``torch.Generator`` seed 0 (the JAX package's demo draws
``jax.random.PRNGKey(0)``, whose bits differ); 4 requests of 16 prompt
tokens (NumPy seed 1) generate 8 greedy tokens each. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs
the plain path on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import all_configs, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Server
from repro_torch.models import transformer as tf
from repro_torch.nn.layers import strict_matmul

ARCHS = ("qwen2.5-14b", "mixtral-8x22b", "recurrentgemma-2b", "xlstm-1.3b")


@dataclasses.dataclass(frozen=True)
class Batch:
    """The requests of one model; the defaults are the JAX demo's."""
    requests: int = 4
    prompt: int = 16
    gen: int = 8
    prompt_seed: int = 1
    init_seed: int = 0


def prompts_for(cfg, b: Batch) -> np.ndarray:
    rng = np.random.default_rng(b.prompt_seed)
    return rng.integers(0, cfg.vocab_size,
                        (b.requests, b.prompt)).astype(np.int32)


def serve(cfg, model, b: Batch) -> dict:
    """``b``'s requests through ``Server.generate`` on ``model`` (any
    weights: random, trained, or the reference's carried across with
    ``models.params.from_reference``)."""
    server = Server(cfg, model)
    t0 = time.time()
    out = server.generate(prompts_for(cfg, b), b.gen)
    dt = time.time() - t0
    return {"arch": cfg.name.removesuffix("-smoke"), "cfg": cfg,
            "model": model, "tokens": out,
            "s": dt, "tokens_per_s": b.requests * b.gen / dt,
            "prefill_s": server.timings["prefill_s"],
            "decode_s": server.timings["decode_s"]}


def run_demo(b: Batch, device, archs=ARCHS) -> dict:
    """Each of ``archs`` reduced, with random weights, served on
    ``device``; returns {arch: the facts of :func:`serve`}."""
    device = resolve_device(device)
    if device.type == "cuda":
        strict_matmul()
    out = {}
    for arch in archs:
        cfg = reduced(all_configs()[arch])
        gen = torch.Generator(device=device)
        gen.manual_seed(b.init_seed)
        out[arch] = serve(cfg, tf.init_params(cfg, gen, device), b)
    return out


def line(f: dict, b: Batch) -> str:
    return (f"{f['arch']:22s} {b.requests} req x {b.gen} tok: "
            f"{f['s']:5.2f}s ({f['tokens_per_s']:6.1f} tok/s) "
            f"sample={f['tokens'][0][:4].tolist()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the weights, caches and kernels")
    args = ap.parse_args()
    b = Batch()
    for f in run_demo(b, args.device).values():
        print(line(f, b))


if __name__ == "__main__":
    main()
