"""DeepSeek-V2's random weights, drawn by the harness from the seed,
under the port's parameter names.

As ``model_weights.py`` draws a dense decoder's: each parameter from a
generator of its own, seeded by (seed, the parameter's name), so the
program's loader and the plain reference (``deepseek_v2_reference.py``)
draw the same numbers and the reference can redraw one layer alone.
Names and shapes are those of the port's ``mla`` blocks
(``units.{u}.b0.*``): the latent attention's ``wq``, ``wkva``,
``kv_norm``, ``wkvb`` and ``wo``; a SwiGLU ``ffn`` in the first
``first_k_dense_replace`` layers, an MoE ``ffn`` (``router``, the routed
experts' stacked ``w1``, ``w3``, ``w2`` and the ``shared`` SwiGLU) in the
rest. Matrices and norm scales follow ``model_weights.draw``; ``wq`` is a
matrix of the spread ``init.query_std``; the router is drawn and kept in
float32 (``init.router_std``).
This module imports nothing of the program.
"""
from __future__ import annotations

import torch

from benchlib import model_weights


def shape_of(config: dict) -> dict:
    """The model's sizes from the configuration's keys."""
    return {"layers": config["num_hidden_layers"],
            "d": config["hidden_size"], "h": config["num_attention_heads"],
            "r": config["kv_lora_rank"], "nope": config["qk_nope_head_dim"],
            "rope": config["qk_rope_head_dim"], "v": config["v_head_dim"],
            "ff": config["intermediate_size"],
            "ffe": config["moe_intermediate_size"],
            "e": config["n_routed_experts"],
            "k": config["num_experts_per_tok"],
            "shared": config["n_shared_experts"],
            "dense": config["first_k_dense_replace"],
            "vocab": config["vocab_size"]}


def layer_specs(config: dict, layer: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of one layer's parameters; kind is ``matrix``,
    ``query`` (a matrix of its own spread), ``norm`` or ``router``."""
    s = shape_of(config)
    d, h, r = s["d"], s["h"], s["r"]
    p = f"units.{layer}.b0."
    out = [(p + "norm1.scale", (d,), "norm"),
           (p + "mixer.wq", (d, h * (s["nope"] + s["rope"])), "query"),
           (p + "mixer.wkva", (d, r + s["rope"]), "matrix"),
           (p + "mixer.kv_norm", (r,), "norm"),
           (p + "mixer.wkvb", (r, h * (s["nope"] + s["v"])), "matrix"),
           (p + "mixer.wo", (h * s["v"], d), "matrix"),
           (p + "norm2.scale", (d,), "norm")]
    if layer < s["dense"]:
        return out + [(p + "ffn.w1", (d, s["ff"]), "matrix"),
                      (p + "ffn.w3", (d, s["ff"]), "matrix"),
                      (p + "ffn.w2", (s["ff"], d), "matrix")]
    e, ffe, fs = s["e"], s["ffe"], s["shared"] * s["ffe"]
    return out + [(p + "ffn.router", (d, e), "router"),
                  (p + "ffn.w1", (e, d, ffe), "matrix"),
                  (p + "ffn.w3", (e, d, ffe), "matrix"),
                  (p + "ffn.w2", (e, ffe, d), "matrix"),
                  (p + "ffn.shared.w1", (d, fs), "matrix"),
                  (p + "ffn.shared.w3", (d, fs), "matrix"),
                  (p + "ffn.shared.w2", (fs, d), "matrix")]


def specs(config: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the model."""
    s = shape_of(config)
    out = [("embed", (s["vocab"], s["d"]), "matrix"),
           ("lm_head", (s["d"], s["vocab"]), "matrix"),
           ("final_norm.scale", (s["d"],), "norm")]
    for u in range(s["layers"]):
        out += layer_specs(config, u)
    return out


def draw(config: dict, seed: int, name: str, shape: tuple, kind: str,
         device) -> torch.Tensor:
    """One parameter: a matrix in the configuration's weight dtype, a norm
    scale or the router in float32."""
    if kind not in ("router", "query"):
        return model_weights.draw(config, seed, name, shape, kind, device)
    g = torch.Generator(device=device)
    g.manual_seed(model_weights._key(seed, name))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, config["init"][f"{kind}_std"], generator=g)
    if kind == "query":
        return t.to(getattr(torch, config["torch_dtype"]))
    return t


def layer(config: dict, seed: int, u: int, device) -> dict:
    """Layer ``u``'s parameters, each in float32 (a matrix holds its
    weight dtype's values), keyed by the name after ``units.{u}.b0.``."""
    prefix = f"units.{u}.b0."
    return {name[len(prefix):]: draw(config, seed, name, shape, kind,
                                     device).float()
            for name, shape, kind in layer_specs(config, u)}
