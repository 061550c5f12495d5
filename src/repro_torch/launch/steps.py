"""Step functions of the serving path; the port of ``make_prefill_step``
and ``make_decode_step`` in ``repro/launch/steps.py``. The train step waits
for the training slice (ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return tf.prefill(model, cfg, batch["inputs"])
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, inputs, pos):
        return tf.decode_step(model, cfg, cache, inputs, pos)
    return decode_step
