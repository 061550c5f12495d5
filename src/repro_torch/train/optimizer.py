"""AdamW with warmup-cosine schedule and global-norm clipping; the port of
``repro/train/optimizer.py``.

The reference is functional: ``adamw_update`` builds new parameter and
moment trees. At full size that is a second copy of 13 GB of moments, so
the port updates in place, under ``torch.no_grad()``, one tensor at a
time, with the reference's arithmetic in the reference's order
(``repro/train/optimizer.py:49-73``). The step count and the schedule live
on the host (a 0-d int32 CPU tensor and float32 NumPy scalars), so an
update never waits for the card.

Weight decay applies where the reference's leaf has ``ndim >= 2``. The
reference stacks each unit's parameters on a leading axis, so every
per-unit vector (norm scales, gate vectors, biases, ``a_param``) is a 2-d
leaf there and is decayed, while the same vectors in a tail block and
``final_norm`` are not. The port keeps units unstacked, so it decides by
the shape of the leaf in the reference's tree (:func:`decays`), not by the
port tensor's ``ndim``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(oc: OptConfig, step) -> np.float32:
    """Learning rate at ``step``, in float32 as the reference computes it."""
    f32 = np.float32
    step = f32(int(step))
    warm = step / f32(max(oc.warmup_steps, 1))
    prog = np.clip((step - f32(oc.warmup_steps))
                   / f32(max(oc.total_steps - oc.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
    return f32(oc.lr) * (warm if step < oc.warmup_steps else cos)


def decays(name: str, t: torch.Tensor) -> bool:
    """Whether AdamW decays parameter ``name``: its leaf in the reference's
    tree has ``ndim >= 2`` (a unit row gains the stacked ``num_units``
    axis there)."""
    unit_row = name.split(".", 1)[0] == "units"
    return t.dim() + int(unit_row) >= 2


def init_opt_state(model: torch.nn.Module) -> dict:
    """{"m", "v": {parameter name: zeros like it}, "count": 0-d int32 on the
    host}."""
    def zeros():
        return {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``.
    Returns the norm before clipping (a 0-d float32 tensor on the grads'
    device)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm


@torch.no_grad()
def adamw_update(oc: OptConfig, model: torch.nn.Module, opt_state: dict):
    """One AdamW step on ``model``'s parameters from their ``.grad``, in
    place, with the moments in ``opt_state`` (``init_opt_state``) updated in
    place and its count advanced. Returns the gradient's global norm before
    clipping. A parameter with no gradient takes a zero gradient, as
    ``jax.grad`` gives it."""
    count = int(opt_state["count"]) + 1
    f32 = np.float32
    lr = float(schedule(oc, count))
    bc1 = float(f32(1.0) - f32(oc.b1) ** f32(count))
    bc2 = float(f32(1.0) - f32(oc.b2) ** f32(count))
    named = list(model.named_parameters())
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = clip_by_global_norm([p.grad for _, p in named], oc.clip_norm)
    for name, p in named:
        g = p.grad.float()
        m, v = opt_state["m"][name], opt_state["v"][name]
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g
        m.mul_(oc.b1).add_(g * (1 - oc.b1))
        v.mul_(oc.b2).add_(g * (1 - oc.b2) * g)
        del g
        # step = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd p), p -= lr step
        step = torch.div(v, bc2).sqrt_().add_(oc.eps)
        step = torch.div(m, bc1).div_(step)
        if decays(name, p):
            step.add_(p * oc.weight_decay)
        p.sub_(step * lr)
        del step
    opt_state["count"] = torch.tensor(count, dtype=torch.int32)
    return gnorm
