"""Meta-tensor stand-ins for every input of a step; the counterpart of
``repro/launch/specs.py``.

Each spec is a tensor on the ``meta`` device: the shape and dtype of the
input, no memory. The trees are in the reference's layout (the units'
parameters and caches stacked on a leading ``num_units`` axis, as
``param_shapes``, ``cache_shapes`` and ``train_state_shapes`` give them
there), built from ``Transformer(cfg, "meta")`` and ``init_cache`` on
``meta``. Dtypes are those of the port on ``device`` (its compute dtype
for activations and caches: bf16 on a card, as the reference's forced
bf16 dry-run gives); a serving cell's parameters are the port's serving
weights there (bf16 where ``nn.layers.weight_dtype`` gives bf16; the
reference counts them in ``param_dtype``), a training cell's the float32
master weights.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell
from repro_torch.device import meta_as
from repro_torch.models import transformer as tf
from repro_torch.models.params import reference_path, unflatten_tree
from repro_torch.nn.layers import compute_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _stacked(cfg: ModelConfig, named) -> dict:
    """The reference's tree of meta tensors for port tensors ``named``
    ((name, tensor) pairs: parameters, or a unit-by-unit cache flattened
    the same way): unit rows stacked on a leading axis."""
    flat: dict = {}
    for name, t in named:
        path, row = reference_path(name)
        if row is None:
            flat[path] = _meta(t.shape, t.dtype)
        elif row == 0:
            flat[path] = _meta((cfg.num_units, *t.shape), t.dtype)
    return unflatten_tree(flat)


def param_shapes(cfg: ModelConfig, device="cuda", *,
                 trainable: bool = False) -> dict:
    """The reference's parameter tree as meta tensors, with the dtypes of
    the port's model on ``device`` (``trainable``: the float32 master
    weights of training)."""
    with meta_as(device):
        model = tf.Transformer(cfg, "meta", trainable)
    return _stacked(cfg, model.named_parameters())


def _flat_cache(cache, prefix="") -> list:
    """(port-style dotted name, leaf) pairs of an ``init_cache`` tree:
    ``units.{u}.b{i}.k`` and ``tail{i}.h``."""
    if isinstance(cache, dict):
        return [kv for k, v in cache.items()
                for kv in _flat_cache(v, f"{prefix}{k}.")]
    if isinstance(cache, list):
        return [kv for i, v in enumerate(cache)
                for kv in _flat_cache(v, f"{prefix}{i}.")]
    return [(prefix[:-1], cache)]


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                 device="cuda") -> dict:
    """The reference's decode-cache tree (units stacked) as meta tensors:
    KV caches in the compute dtype of ``device``, recurrent states in
    float32."""
    with meta_as(device):
        cache = tf.init_cache(cfg, batch, capacity, "meta")
    return _stacked(cfg, _flat_cache(cache))


def train_state_shapes(cfg: ModelConfig) -> dict:
    """The reference's train state (``launch/steps.py:83``) as meta
    tensors: float32 params, AdamW's m and v like them, int32 count and
    step."""
    def params():
        return param_shapes(cfg, trainable=True)
    return {"params": params(),
            "opt": {"m": params(), "v": params(),
                    "count": _meta((), torch.int32)},
            "step": _meta((), torch.int32)}


def batch_specs(cfg: ModelConfig, cell: ShapeCell, device="cuda"):
    B, S = cell.global_batch, cell.seq_len
    if cfg.embed_mode == "tokens":
        inputs = _meta((B, S), torch.int32)
    else:
        inputs = _meta((B, S, cfg.d_model), compute_dtype(device))
    return {"inputs": inputs, "labels": _meta((B, S), torch.int32)}


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell, device="cuda"):
    B, S = cell.global_batch, cell.seq_len
    if cfg.embed_mode == "tokens":
        inputs = _meta((B, 1), torch.int32)
    else:
        inputs = _meta((B, 1, cfg.d_model), compute_dtype(device))
    return {"inputs": inputs, "cache": cache_shapes(cfg, B, S, device),
            "pos": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape_name: str, device="cuda"):
    """All inputs of the step that this shape cell runs: train
    ``{"state", "batch"}``, prefill ``{"params", "batch"}``, decode
    ``{"params", "inputs", "cache", "pos"}``."""
    cell = SHAPES[shape_name]
    if cell.kind == "train":
        return {"state": train_state_shapes(cfg),
                "batch": batch_specs(cfg, cell, device)}
    params = param_shapes(cfg, device)
    if cell.kind == "prefill":
        return {"params": params,
                "batch": {"inputs": batch_specs(cfg, cell, device)["inputs"]}}
    return {"params": params, **decode_input_specs(cfg, cell, device)}
