"""Carrying weights between the reference's parameter tree and the port's
model.

The reference keeps its parameters as a nested dict whose ``units``
subtree is stacked on a leading ``num_units`` axis
(``transformer.py:74-77``); the port keeps one module per unit. A
reference tree as NumPy arrays (``jax.tree.map(np.asarray, params)``, or a
checkpoint's ``params``) maps onto the port's parameters by path:
``units/b0/mixer/in_x`` row ``u`` is ``units.{u}.b0.mixer.in_x``, and
``tail{i}/...`` is ``tail{i}....``. :func:`to_reference` is the inverse.
The optimizer's moments ``m`` and ``v`` have the parameters' tree; they are
dicts keyed by parameter name and cross with :func:`named_to_reference`
and :func:`load_named`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_host
from repro_torch.models.transformer import Transformer


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def reference_path(name: str) -> tuple[str, int | None]:
    """Port parameter name -> (reference path, unit row or None)."""
    parts = name.split(".")
    if parts[0] == "units":
        return "/".join(["units"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


_reference_path = reference_path


def load_named(named: dict, tree: dict) -> None:
    """Copy a reference tree of arrays into the tensors of ``named`` ({port
    parameter name: tensor}, a model's parameters or an optimizer moment),
    in place, each cast to its tensor's dtype on its device. The tree must
    hold exactly those tensors."""
    flat = flatten_tree(tree)
    seen = set()
    for name, t in named.items():
        path, row = reference_path(name)
        if path not in flat:
            raise KeyError(f"reference tree lacks {path!r}")
        arr = np.asarray(flat[path])
        if row is not None:
            arr = arr[row]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
        seen.add(path)
    extra = sorted(set(flat) - seen)
    if extra:
        raise KeyError(f"reference tree has leaves the port lacks: {extra}")


def load_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a reference tree of arrays into ``module``'s parameters (see
    :func:`load_named`)."""
    load_named(dict(module.named_parameters()), tree)
    return module


def from_reference(tree: dict, cfg: ModelConfig, device,
                   trainable: bool = False) -> Transformer:
    """The port's model holding the reference's weights ``tree`` (nested
    dict of NumPy arrays) on ``device``; ``trainable`` as for
    ``Transformer``."""
    return load_tree(Transformer(cfg, resolve_device(device), trainable),
                     tree)


def named_to_reference(named: dict, dtype=np.float32) -> dict:
    """The reference's tree (nested dict of NumPy arrays, units stacked)
    of ``named`` ({port parameter name: tensor}). Leaves are ``dtype``,
    the reference's ``param_dtype``."""
    flat: dict = {}
    rows: dict = {}
    for name, t in named.items():
        path, row = reference_path(name)
        arr = to_host(t.float() if t.dtype == torch.bfloat16 else t) \
            .astype(dtype, copy=False)
        if row is None:
            flat[path] = arr
        else:
            rows.setdefault(path, {})[row] = arr
    for path, by_row in rows.items():
        flat[path] = np.stack([by_row[u] for u in range(len(by_row))])
    return unflatten_tree(flat)


def to_reference(model: nn.Module, dtype=np.float32) -> dict:
    """The reference's parameter tree of ``model`` (see
    :func:`named_to_reference`); on the CPU the round trip from_reference
    -> to_reference is byte-identical."""
    return named_to_reference(dict(model.named_parameters()), dtype)


def reference_shapes(cfg: ModelConfig) -> dict:
    """Zeros in the shape of the reference's parameter tree (float32, units
    stacked), allocated lazily by NumPy: the ``like`` structure of a
    checkpoint restore."""
    model = Transformer(cfg, "meta")
    flat = {}
    for name, t in model.named_parameters():
        path, row = reference_path(name)
        shape = tuple(t.shape) if row is None else (cfg.num_units,
                                                     *t.shape)
        flat[path] = np.zeros(shape, np.float32)
    return unflatten_tree(flat)
