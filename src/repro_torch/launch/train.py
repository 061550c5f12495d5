"""Training driver — the training loop IS a protocol-dataflow program; the
port of ``repro/launch/train.py``.

    ingress (data pipeline views) -> step vertex (train_step)
        -> egress (metrics) + checkpoint vertex (versioned snapshots)

Fault tolerance end to end: ``--fail-at N`` kills the step vertex at step
N; the driver restores ``snapshot(latest)`` (paper §2.3.1 rule), rebuilds
the pipeline at the restored batch index (deterministic views => no data
loss or duplication) and continues. ``--compress`` enables int8
error-feedback gradient compression. Checkpoints hold the reference's
train-state tree, so either package restores the other's.

On a card the train step runs the hand-written kernels forwards
(``lru_scan``, ``flash_attention``) and backwards (``lru_scan_bwd``,
``flash_attention_bwd``); on the CPU the plain versions, differentiated
by autograd.

Usage (reduced config; ``--device cpu`` runs on the host):
    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
        --arch qwen2.5-14b --steps 50 --batch 8 --seq 64 --fail-at 23

``--full-size`` trains the full config; one whose float32 training state
does not fit the card is refused with the depth that would fit, to be cut
with ``dataclasses.replace(cfg, num_layers=N)`` and trained through
:func:`run`.
``xlstm-1.3b`` trains on the chunkwise mLSTM route
(``mlstm_impl="chunkwise"``, ``mlstm_chunk`` set): its config's own scan
keeps a (B, 4, 1024, 1024) float32 state for every step under autograd.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import all_configs, reduced
from repro_torch.core.protocol_dataflow import (Dataflow, Egress, Ingress,
                                                Protocol, Vertex)
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (init_train_state, load_state, loss_fn,
                                      make_train_step, reference_state_like,
                                      state_to_reference)
from repro_torch.nn.layers import strict_matmul
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import compress_grads, init_error_state
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import OptConfig, adamw_update

TRAIN = Protocol("train-loop", validate=lambda m: isinstance(m, tuple))
# main's checkpoints go to a new directory per run under this one (in the
# repository's build/ directory, which git ignores) unless --ckpt-dir is
# given: a directory that already holds a run's versions refuses to write
# them again, and its latest snapshot would be another run's
CKPT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "train_ckpt"


class SimulatedFailure(RuntimeError):
    pass


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def build_step_vertex(cfg, state_box, oc_kw, *, compress=False, fail_at=None,
                      timings=None):
    """The train_step vertex. ``timings``, when a list, receives each
    step's seconds on the host clock (ending when its metrics reach the
    host, which waits for the card)."""
    oc = OptConfig(**oc_kw)
    step_fn = make_train_step(cfg, oc)
    err_box = {"err": None}

    def fn(vertex, port, payloads):
        outs = []
        for (idx, batch) in payloads:
            if fail_at is not None and idx == fail_at and \
                    not state_box.get("failed_once"):
                state_box["failed_once"] = True
                raise SimulatedFailure(f"injected failure at step {idx}")
            t0 = time.perf_counter()
            state = state_box["state"]
            if compress:
                # quantize/dequantize grads with error feedback around the
                # (here absent) data-parallel all-reduce
                model = state["params"]
                loss, metrics = loss_fn(model, cfg, batch)
                loss.backward()
                grads = {n: p.grad for n, p in model.named_parameters()}
                if err_box["err"] is None:
                    err_box["err"] = init_error_state(grads)
                deq, err_box["err"], cstats = compress_grads(
                    grads, err_box["err"])
                for n, p in model.named_parameters():
                    p.grad = deq[n]
                del grads, deq
                gnorm = adamw_update(oc, model, state["opt"])
                model.zero_grad(set_to_none=True)
                state["step"] = state["step"] + 1
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                               compress_ratio=cstats["ratio"])
            else:
                state, metrics = step_fn(state, batch)
            state_box["state"] = state
            host = {k: float(v) for k, v in metrics.items()}
            if timings is not None:
                timings.append(time.perf_counter() - t0)
            outs.append(("out", (idx, host)))
        return outs

    return Vertex("train_step", TRAIN, fn)


def run(cfg, *, steps, batch, seq, ckpt_dir, ckpt_every=10, fail_at=None,
        compress=False, log_every=10, seed=0, device="cuda", timings=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``. Returns (losses {step: loss}, final state). ``timings``:
    see :func:`build_step_vertex`."""
    device = resolve_device(device)
    pipeline = TokenPipeline(
        cfg.vocab_size, batch, seq, seed=seed,
        frames_dim=cfg.d_model if cfg.embed_mode == "frames" else None)
    state_box = {"state": init_train_state(cfg, _generator(seed, device),
                                           device)}
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses = {}

    df = Dataflow("training")
    ingress = df.add(Ingress("data", TRAIN))
    stepv = df.add(build_step_vertex(cfg, state_box, {}, compress=compress,
                                     fail_at=fail_at, timings=timings))

    def on_metrics(payload):
        idx, metrics = payload
        losses[idx] = metrics["loss"]
        if idx % log_every == 0:
            print(f"  step {idx:4d} loss={metrics['loss']:.4f} "
                  + (f"ratio={metrics.get('compress_ratio', 0):.1f}x"
                     if compress else ""))
        if ckpt and idx and idx % ckpt_every == 0:
            done = int(state_box["state"]["step"])
            ckpt.save(state_to_reference(state_box["state"]), epoch=0,
                      step=done)

    egress = df.add(Egress("metrics", TRAIN, on_metrics))
    ingress.connect("out", stepv)
    stepv.connect("out", egress)

    i = 0
    while i < steps:
        try:
            ingress.push([(i, pipeline.batch_view(i).value())])
            df.run_until_quiescent()
            i += 1
        except SimulatedFailure as e:
            print(f"  !! {e} — restoring snapshot + replaying")
            state = state_box["state"]
            state["params"].zero_grad(set_to_none=True)
            if ckpt and ckpt.versions():
                load_state(state, ckpt.restore(reference_state_like(cfg)))
                i = int(state["step"])
            else:
                state_box["state"] = init_train_state(
                    cfg, _generator(seed, device), device)
                i = 0
    df.deliver_events()
    return losses, state_box["state"]


# bytes of training state per parameter: the float32 master weight, its
# gradient and AdamW's m and v
STATE_BYTES_PER_PARAM = 16
# the share of the card's memory the training state may take, the rest left
# to activations
FIT_SHARE = 0.75


def depth_that_fits(cfg, memory_bytes: int) -> int:
    """The most layers of ``cfg`` (its pattern's first kind, at full width)
    whose training state takes at most FIT_SHARE of ``memory_bytes``; 0
    when not even the embeddings fit."""
    kinds = list(cfg.pattern) * cfg.num_units + list(cfg.tail_pattern)
    base = cfg.param_count() - sum(cfg._block_params(k) for k in kinds)
    per_layer = cfg._block_params(cfg.pattern[0])
    room = FIT_SHARE * memory_bytes / STATE_BYTES_PER_PARAM - base
    return max(0, int(room // per_layer))


def check_fits(cfg, device) -> None:
    """Refuse (SystemExit) a config whose training state, 16 bytes a
    parameter, exceeds FIT_SHARE of the card's memory, naming the depth
    that fits."""
    if device.type != "cuda":
        return
    total = torch.cuda.get_device_properties(device).total_memory
    need = STATE_BYTES_PER_PARAM * cfg.param_count()
    if need <= FIT_SHARE * total:
        return
    raise SystemExit(
        f"{cfg.name} at full size needs {need / 2**30:.1f} GiB of float32 "
        f"weights, gradients and AdamW moments, more than {FIT_SHARE:.0%} "
        f"of the card's {total / 2**30:.1f} GiB (the rest is left to "
        f"activations): cut its depth to {depth_that_fits(cfg, total)} of "
        f"its {cfg.num_layers} layers "
        "(dataclasses.replace(cfg, num_layers=N), trained through "
        "repro_torch.launch.train.run)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b",
                    choices=sorted(all_configs()))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config, not the reduced one")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new directory under build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device for the model, optimizer and kernels")
    args = ap.parse_args()

    device = resolve_device(args.device)
    strict_matmul()
    if args.ckpt_dir is None:
        CKPT_ROOT.mkdir(parents=True, exist_ok=True)
        args.ckpt_dir = tempfile.mkdtemp(prefix="run_", dir=CKPT_ROOT)
    cfg = all_configs()[args.arch]
    if not args.full_size:
        cfg = reduced(cfg)
    check_fits(cfg, device)
    print(f"training {cfg.name}: {cfg.param_count():,} params, "
          f"{args.steps} steps of {args.batch}x{args.seq} on {device}")
    t0 = time.time()
    losses, state = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        fail_at=args.fail_at, compress=args.compress,
                        seed=args.seed, device=device)
    first = np.mean([losses[i] for i in sorted(losses)[:5]])
    last = np.mean([losses[i] for i in sorted(losses)[-5:]])
    print(f"loss {first:.4f} -> {last:.4f} in {time.time()-t0:.1f}s "
          f"({len(losses)} steps)")
    assert last < first, "loss did not improve"


if __name__ == "__main__":
    main()
