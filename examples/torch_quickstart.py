"""Quickstart on the PyTorch port: train a small LM with the full stack
(protocol-dataflow training loop, versioned checkpoints, deterministic
data views) on ``--device``, then serve from the newest snapshot.

    PYTHONPATH=src python examples/torch_quickstart.py

The sizes are the JAX package's quickstart's: reduced qwen2.5-14b
(2 layers, d_model 128, vocabulary 128), 60 steps of 16 x 64 Markov
tokens, checkpoints every 20 steps, then 2 prompts of 8 tokens and 8
greedy tokens from the trained float32 weights. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain path
on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import all_configs, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Server
from repro_torch.launch.train import run
from repro_torch.nn.layers import strict_matmul
from repro_torch.train.data import MarkovLM, unigram_entropy_floor


@dataclasses.dataclass(frozen=True)
class Quick:
    """One run; the defaults are the JAX quickstart's."""
    steps: int = 60
    batch: int = 16
    seq: int = 64
    ckpt_every: int = 20
    log_every: int = 20
    prompts: int = 2
    prompt_len: int = 8
    gen: int = 8


def config():
    return reduced(all_configs()["qwen2.5-14b"], num_layers=2, d_model=128,
                   vocab_size=128, loss_chunk=512)


def prompts_for(cfg, q: Quick) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (q.prompts, q.prompt_len)).astype(np.int32)


def serve(cfg, model, q: Quick) -> np.ndarray:
    """Greedy tokens of ``q``'s prompts from ``model`` as it is (the
    trainable float32 module serves as the reference serves its float32
    params: no cast)."""
    return Server(cfg, model).generate(prompts_for(cfg, q), q.gen)


def run_demo(q: Quick, device) -> dict:
    """Train on ``device`` through ``launch.train.run`` (checkpoints in a
    temporary directory), then serve the trained weights; returns the
    facts."""
    if resolve_device(device).type == "cuda":
        strict_matmul()
    cfg = config()
    out = {"config": cfg.name, "params": cfg.param_count(),
           "entropy_floor": unigram_entropy_floor(MarkovLM(cfg.vocab_size))}
    with tempfile.TemporaryDirectory() as tmp:
        losses, state = run(cfg, steps=q.steps, batch=q.batch, seq=q.seq,
                            ckpt_dir=tmp,
                            ckpt_every=q.ckpt_every, log_every=q.log_every,
                            device=device)
    order = sorted(losses)
    out["losses"] = [losses[i] for i in order]
    out["first"] = float(np.mean([losses[i] for i in order[:5]]))
    out["last"] = float(np.mean([losses[i] for i in order[-5:]]))
    out["generated"] = serve(cfg, state["params"], q)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the training run and the server")
    args = ap.parse_args()
    cfg = config()
    print(f"config: {cfg.name}, {cfg.param_count():,} params")
    print(f"unigram entropy floor: "
          f"{unigram_entropy_floor(MarkovLM(cfg.vocab_size)):.3f} nats")
    f = run_demo(Quick(), args.device)
    print(f"train loss: {f['first']:.3f} -> {f['last']:.3f}")
    print("generated:", f["generated"][0].tolist())


if __name__ == "__main__":
    main()
