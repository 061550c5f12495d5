"""A model configuration's random weights, drawn by the harness from the
seed, under the port's parameter names.

Each parameter comes from a generator of its own, seeded by (seed, the
parameter's name), on the device that holds it, so the program's loader
and the plain reference (``model_reference.py``) draw the same numbers
and the reference can redraw one layer alone. The names and shapes are
those of a dense decoder with one attention kind (``units.{u}.b0.*``, as
the port's ``models/params.py`` names them); this module imports nothing
of the program.

Distributions (the configuration's ``init``): every matrix from N(0,
``std``^2) drawn in float32 and rounded to the configuration's weight
dtype, as the port's initialiser draws them; the norm scales (the
multiplier is 1 + scale) and the attention biases, which the port's
initialiser leaves at zero, from N(0, ``norm_scale_std``^2) and N(0, (
``bias_share`` * ``std`` * sqrt(hidden_size))^2): a bias that spreads like
a share of its projection's output, so that a program which drops it
reads otherwise.
"""
from __future__ import annotations

import hashlib
import math

import torch


def shape_of(config: dict) -> dict:
    """The decoder's sizes from the configuration's keys."""
    d = config["hidden_size"]
    hq = config["num_attention_heads"]
    return {"layers": config["num_hidden_layers"], "d": d, "hq": hq,
            "hkv": config["num_key_value_heads"], "hd": d // hq,
            "ff": config["intermediate_size"], "vocab": config["vocab_size"]}


def layer_specs(config: dict, layer: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of one decoder layer's parameters; kind is
    ``matrix``, ``bias`` or ``norm``."""
    s = shape_of(config)
    d, q, kv, ff = s["d"], s["hq"] * s["hd"], s["hkv"] * s["hd"], s["ff"]
    p = f"units.{layer}.b0."
    out = [(p + "norm1.scale", (d,), "norm"),
           (p + "mixer.wq", (d, q), "matrix"),
           (p + "mixer.wk", (d, kv), "matrix"),
           (p + "mixer.wv", (d, kv), "matrix"),
           (p + "mixer.wo", (q, d), "matrix")]
    if config["qkv_bias"]:
        out += [(p + "mixer.bq", (q,), "bias"), (p + "mixer.bk", (kv,), "bias"),
                (p + "mixer.bv", (kv,), "bias")]
    return out + [(p + "norm2.scale", (d,), "norm"),
                  (p + "ffn.w1", (d, ff), "matrix"),
                  (p + "ffn.w3", (d, ff), "matrix"),
                  (p + "ffn.w2", (ff, d), "matrix")]


def specs(config: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the model."""
    s = shape_of(config)
    out = [("embed", (s["vocab"], s["d"]), "matrix"),
           ("lm_head", (s["d"], s["vocab"]), "matrix"),
           ("final_norm.scale", (s["d"],), "norm")]
    for u in range(s["layers"]):
        out += layer_specs(config, u)
    return out


def _key(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def draw(config: dict, seed: int, name: str, shape: tuple, kind: str,
         device) -> torch.Tensor:
    """One parameter: a matrix in the configuration's weight dtype, a
    bias or norm scale in float32."""
    init = config["init"]
    if kind == "matrix":
        std = init["std"]
    elif kind == "bias":
        std = init["bias_share"] * init["std"] * math.sqrt(
            config["hidden_size"])
    else:
        std = init["norm_scale_std"]
    g = torch.Generator(device=device)
    g.manual_seed(_key(seed, name))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, std, generator=g)
    if kind == "matrix":
        return t.to(getattr(torch, config["torch_dtype"]))
    return t


def layer(config: dict, seed: int, u: int, device) -> dict:
    """Layer ``u``'s parameters, each in float32 (a matrix holds its
    weight dtype's values), keyed by the name after ``units.{u}.b0.``."""
    prefix = f"units.{u}.b0."
    return {name[len(prefix):]: draw(config, seed, name, shape, kind,
                                     device).float()
            for name, shape, kind in layer_specs(config, u)}
