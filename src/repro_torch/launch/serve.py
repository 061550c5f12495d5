"""Model server: batched prefill + decode with KV caches; the port of
``repro/launch/serve.py``.

The server reads model weights from the newest checkpoint *snapshot*
(never blocking the trainer that produces them) and answers batched
generation requests. On a card the prefill runs the ``lru_scan`` kernel in
every RG-LRU layer and the ``flash_attention`` kernel in every attention
layer; MoE feed-forwards (``nn/moe.py``), the xLSTM's mLSTM and sLSTM
mixers and decode are plain tensor code.
``Server.generate`` takes token prompts only, as the reference's does; a
frames model (``embed_mode="frames"``) is driven through
``models.transformer.prefill`` and ``launch.steps.make_decode_step``.

Usage (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 4 --prompt-len 16 --gen 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.device import resolve_device, to_host
from repro_torch.launch.steps import make_decode_step, reference_state_like
from repro_torch.models import params as mp
from repro_torch.models import transformer as tf
from repro_torch.nn.layers import strict_matmul
from repro_torch.train.checkpoint import (CheckpointManager,
                                          CheckpointStructureError)


class Server:
    def __init__(self, cfg, params: tf.Transformer):
        """``params``: the model (``tf.init_params`` or
        ``models.params.from_reference``); it serves on its device. On a
        card the reference's numerics need ``nn.layers.strict_matmul()``
        called once first, as ``main`` does."""
        self.cfg = cfg
        self.params = params
        self.decode = make_decode_step(cfg)
        # seconds of the last generate's prefill and decode loop, each
        # ending in a device synchronise
        self.timings: dict[str, float] = {}

    def _sync(self) -> None:
        if self.params.device.type == "cuda":
            torch.cuda.synchronize(self.params.device)

    @torch.inference_mode()
    def generate(self, prompts, max_new: int, *, greedy=True, seed=0):
        """prompts: (B, P) int32 (tokens mode). Returns (B, max_new) int32.
        ``greedy=False`` samples from softmax(logits) with a
        ``torch.Generator(seed)``: its draws differ from ``jax.random``'s.
        Raises ``ValueError`` on a frames model, which has no tokens to
        feed back."""
        cfg = self.cfg
        if cfg.embed_mode != "tokens":
            raise ValueError(
                f"{cfg.name} takes frames, and Server.generate is "
                "tokens-only: run models.transformer.prefill on (B, S, D) "
                "frames and launch.steps.make_decode_step on (B, 1, D) ones")
        dev = self.params.device
        prompts = torch.as_tensor(np.asarray(prompts), device=dev)
        B, P = prompts.shape
        capacity = P + max_new
        t0 = time.perf_counter()
        logits, cache = tf.prefill(self.params, cfg, prompts,
                                   capacity=capacity)
        self._sync()
        t1 = time.perf_counter()
        out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        for t in range(max_new):
            out[:, t] = tok
            logits, cache = self.decode(self.params, cache, tok[:, None],
                                        P + t)
            if greedy:
                tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            else:
                probs = torch.softmax(logits[:, 0], dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0] \
                    .to(torch.int32)
        host = to_host(out)
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1}
        return host

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir, version=None, *, device="cuda"):
        """Read the newest snapshot (paper rule): a checkpoint of the full
        train state (params plus optimizer leaves) or of params alone, with
        the reference's flat keys, so either package's checkpoints load."""
        mgr = CheckpointManager(ckpt_dir)
        # Only a STRUCTURE mismatch (a params-only checkpoint lacking the
        # optimizer leaves) falls back to the narrower shape; a corrupt
        # checkpoint, bad dtype or IO error surfaces as itself.
        try:
            state = mgr.restore(reference_state_like(cfg), version)
        except CheckpointStructureError:
            state = mgr.restore(reference_state_like(cfg, with_opt=False),
                                version)
        return cls(cfg, mp.from_reference(state["params"], cfg, device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=sorted(all_configs()))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device for the weights, caches and kernels")
    args = ap.parse_args()

    device = resolve_device(args.device)
    strict_matmul()
    cfg = reduced(get_config(args.arch))
    if args.ckpt_dir:
        server = Server.from_checkpoint(cfg, args.ckpt_dir, device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        server = Server(cfg, tf.init_params(cfg, gen, device))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = server.generate(prompts, args.gen)
    dt = time.time() - t0
    print(f"served {args.requests} requests x {args.gen} tokens "
          f"in {dt:.2f}s ({args.requests*args.gen/dt:.1f} tok/s) on {device}")
    print("sample:", out[0].tolist())


if __name__ == "__main__":
    main()
