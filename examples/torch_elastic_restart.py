"""Elastic scaling + gradient compression example on the PyTorch port.

Trains on ``--device``, checkpoints a versioned snapshot, then 'loses'
the cluster: restores snapshot(v) and reshards the state onto a new mesh
(``launch.mesh.make_local_mesh``: this machine's cards, or the CPU), and
resumes training there. Also shows the int8 error-feedback compression
path.

    PYTHONPATH=src python examples/torch_elastic_restart.py

The sizes are the JAX package's example's: reduced qwen2.5-14b (2
layers), 25 steps of 8 x 32 tokens with ``compress=True`` and
checkpoints every 10 steps, then 5 steps resumed from the restored
step. ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` runs the plain path on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import all_configs, reduced
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import run
from repro_torch.nn.layers import strict_matmul
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline
from repro_torch.train.elastic import elastic_restart


@dataclasses.dataclass(frozen=True)
class Elastic:
    """One run; the defaults are the JAX example's."""
    steps: int = 25
    batch: int = 8
    seq: int = 32
    ckpt_every: int = 10
    log_every: int = 10
    resume: int = 5


def config():
    return reduced(all_configs()["qwen2.5-14b"], num_layers=2)


def train(e: Elastic, device, ckpt_dir) -> dict:
    """Phase 1: ``launch.train.run`` with int8 gradient compression,
    checkpoints under ``ckpt_dir``."""
    losses, _ = run(config(), steps=e.steps, batch=e.batch, seq=e.seq,
                    ckpt_dir=ckpt_dir, ckpt_every=e.ckpt_every,
                    compress=True, log_every=e.log_every, device=device)
    return {"losses": [losses[i] for i in sorted(losses)]}


def restart_and_resume(e: Elastic, device, ckpt_dir) -> dict:
    """Phases 2-3: the newest snapshot under ``ckpt_dir`` (written by
    either package) restored onto a new mesh on ``device``, then
    ``e.resume`` train steps from the restored step's batch index."""
    cfg = config()
    new_mesh = make_local_mesh(device)
    state = elastic_restart(cfg, CheckpointManager(ckpt_dir),
                            steps.reference_state_like(cfg), new_mesh)
    restored = int(state["step"])
    if not 0 < restored <= e.steps:
        raise RuntimeError(f"restored at step {restored}, outside "
                           f"(0, {e.steps}]")
    step_fn = steps.make_train_step(cfg)
    pipe = TokenPipeline(cfg.vocab_size, e.batch, e.seq, seed=0)
    resumed = []
    for j in range(restored, restored + e.resume):
        state, metrics = step_fn(state, pipe.batch_view(j).value())
        resumed.append(float(metrics["loss"]))
    return {"restored": restored,
            "mesh": dict(zip(new_mesh.axis_names, new_mesh.shape,
                             strict=True)),
            "mesh_device": str(state["params"].device),
            "resumed": resumed, "final_step": int(state["step"])}


def run_demo(e: Elastic, device) -> dict:
    """All three phases on ``device``, the checkpoints in a temporary
    directory; returns the facts."""
    if resolve_device(device).type == "cuda":
        strict_matmul()
    with tempfile.TemporaryDirectory() as d:
        return {**train(e, device, d), **restart_and_resume(e, device, d)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the training run and the new mesh")
    args = ap.parse_args()
    e = Elastic()
    if resolve_device(args.device).type == "cuda":
        strict_matmul()
    with tempfile.TemporaryDirectory() as d:
        print("phase 1: train 25 steps with int8 grad compression")
        train(e, args.device, d)
        print("phase 2: elastic restart on a new mesh from snapshot(v)")
        f = restart_and_resume(e, args.device, d)
        print(f"  restored at step {f['restored']}, resharded to mesh "
              f"{f['mesh']} on {f['mesh_device']}")
        print("phase 3: resume training on the new mesh")
        print(f"  resumed {f['restored']} -> {f['final_step']}, "
              f"loss={f['resumed'][-1]:.4f}")
    print("OK")


if __name__ == "__main__":
    main()
