"""Step functions: train_step, prefill_step, decode_step; the port of
``repro/launch/steps.py``.

They close over the ModelConfig and take the model and tensors. The
reference's train step is a pure function of a state pytree; the port's
updates its state in place (the model's parameters, the optimizer's
moments), because at full size a second copy does not fit. The state is
``{"params": model, "opt": {"m", "v", "count"}, "step"}`` (``m`` and ``v``
dicts keyed by parameter name, ``count`` and ``step`` 0-d int32 tensors on
the host); :func:`state_to_reference` gives the reference's train-state
tree of it, whose checkpoint either package restores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as mp
from repro_torch.models import transformer as tf
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)

AUX_LOSS_WEIGHT = 0.01


def make_positions(batch: int, seq: int, device="cpu") -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None] \
        .expand(batch, seq)


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def loss_fn(model: tf.Transformer, cfg: ModelConfig, batch, use_kernel=None):
    """Mean cross entropy of ``batch`` plus ``AUX_LOSS_WEIGHT`` times the
    MoE load-balancing loss (0 for a model without MoE). ``batch``:
    {"inputs": (B, S) token ids, or (B, S, D) float frames for a frames
    model (``TokenPipeline(frames_dim=D)``); "labels": (B, S) token ids},
    NumPy or tensors. Returns (loss, {"ce", "aux"})."""
    dev = model.device
    inputs = _on(batch["inputs"], dev)
    B, S = inputs.shape[:2]
    hidden, aux = tf.forward(model, cfg, inputs, make_positions(B, S, dev),
                             use_kernel)
    loss_sum, cnt = chunked_cross_entropy(
        model.lm_head, hidden, _on(batch["labels"], dev),
        chunk=cfg.loss_chunk, softcap=cfg.logit_softcap)
    loss = loss_sum / torch.clamp(cnt, min=1.0)
    return loss + AUX_LOSS_WEIGHT * aux, {"ce": loss, "aux": aux}


def make_train_step(cfg: ModelConfig, oc: OptConfig | None = None):
    """train_step(state, batch) -> (state, metrics): the loss's gradient
    (accumulated over ``cfg.microbatches`` splits of the batch, only one
    split's activations live at a time), then one AdamW update, all in
    place. metrics: ce, aux, loss, grad_norm (0-d tensors)."""
    oc = OptConfig() if oc is None else oc
    mb = max(cfg.microbatches, 1)

    def train_step(state, batch):
        model = state["params"]
        if mb == 1:
            loss, metrics = loss_fn(model, cfg, batch)
            loss.backward()
        else:
            # the grads of the splits add up in .grad (float32), then one
            # division: the reference's scan of sums over microbatches
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            splits = {k: torch.chunk(_on(v, model.device), mb)
                      for k, v in batch.items()}
            for i in range(mb):
                loss, _ = loss_fn(model, cfg,
                                  {k: v[i] for k, v in splits.items()})
                loss.backward()
                loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(mb)
            loss = loss_sum / mb
            # the reference's metrics here: "ce" is the mean of the splits'
            # whole losses (the aux term included), "aux" 0
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        gnorm = adamw_update(oc, model, state["opt"])
        model.zero_grad(set_to_none=True)
        state["step"] = state["step"] + 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)
    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device) -> dict:
    """A fresh train state: a trainable model with random weights from
    ``generator`` on ``device``, zero moments, step 0."""
    return state_of(tf.init_params(cfg, generator, device, trainable=True))


def state_of(model: tf.Transformer) -> dict:
    """A train state at step 0 around a trainable ``model``."""
    return {"params": model, "opt": init_opt_state(model),
            "step": torch.zeros((), dtype=torch.int32)}


def state_to_reference(state: dict) -> dict:
    """The reference's train-state tree of ``state`` (NumPy leaves, units
    stacked): what a checkpoint holds."""
    opt = state["opt"]
    return {"params": mp.to_reference(state["params"]),
            "opt": {"m": mp.named_to_reference(opt["m"]),
                    "v": mp.named_to_reference(opt["v"]),
                    "count": np.asarray(int(opt["count"]), np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}


def reference_state_like(cfg: ModelConfig, with_opt: bool = True) -> dict:
    """Zeros in the structure of the reference's train state (or of
    ``{"params"}`` alone): the ``like`` of a checkpoint restore."""
    params = mp.reference_shapes(cfg)
    if not with_opt:
        return {"params": params}

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}
    return {"params": params,
            "opt": {"m": zeros(params), "v": zeros(params),
                    "count": np.zeros((), np.int32)},
            "step": np.zeros((), np.int32)}


def load_state(state: dict, tree: dict) -> dict:
    """Copy a reference train-state tree (a restored checkpoint) into
    ``state`` in place; returns ``state``."""
    mp.load_tree(state["params"], tree["params"])
    mp.load_named(state["opt"]["m"], tree["opt"]["m"])
    mp.load_named(state["opt"]["v"], tree["opt"]["v"])
    state["opt"]["count"] = torch.tensor(int(tree["opt"]["count"]),
                                         dtype=torch.int32)
    state["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32)
    return state


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return tf.prefill(model, cfg, batch["inputs"])
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, inputs, pos):
        return tf.decode_step(model, cfg, cache, inputs, pos)
    return decode_step
