"""The composable decoder; the port of ``repro/models/transformer.py``.

The block *pattern* (the repeating unit of mixer kinds) is an
``nn.ModuleDict`` of blocks ``b{i}``; the model holds ``num_units`` of them
in a ``ModuleList`` walked by a Python loop (the reference stacks their
parameters on a leading axis and scans), then a tail of
``num_layers % len(pattern)`` blocks named ``tail{i}``. The port runs every
mixer kind of the reference: the attention kinds and ``rglru`` with
``mlp`` or MoE (``nn/moe.py``) feed-forwards, optionally with post-block
("sandwich") norms, and the xLSTM's ``mlstm`` and ``slstm``, which carry
their own projections and have no feed-forward; and one of its own,
DeepSeek-V2's latent attention ``mla`` (``nn/mla.py``), whose decode
cache is the latent beside the attention kinds' keys and values. A
block's feed-forward is ``cfg.ffn_kind(layer)``: an MoE model's first
``cfg.first_k_dense`` layers take a SwiGLU of ``d_ff``. Inputs are (B, S)
token ids or, with ``embed_mode="frames"``, (B, S, D) frames
(precomputed embeddings; the model then has no ``embed`` table).

A model is built for serving (bf16 frozen weights on a card, but for what
the reference reads in float32: norm scales, biases, MoE routers and the
recurrent mixers' convolutions, gates and per-head products) or, with
``trainable=True``, for training: every parameter in ``cfg.param_dtype``
(float32 master weights) with ``requires_grad``.

Forward paths, each taking ``use_kernel`` (None: the CUDA kernels on a
card, the plain versions on the CPU):
  * ``forward``       — (B, S) tokens or (B, S, D) frames -> (B, S, D)
                        hidden (+ the MoE aux loss); the
                        training body, with ``cfg.remat`` applied to the
                        units (never to the tail blocks, as in the
                        reference, which remats its scanned units only).
  * ``prefill``       — forward + the decode caches filled at the prompt's
                        end.
  * ``decode_step``   — one token (or frame) with per-layer caches (KV /
                        recurrent).

The reference's ``launch/sharding.constrain`` mesh hints are left out:
on one card the port's ``launch.sharding.constrain`` returns its input.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN_KINDS, FFN_MIXERS, ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import mla as mla_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import recurrent as rec
from repro_torch.nn.layers import (MLP, Norm, apply_norm,
                                   bf16_backward_enabled, bf16_backward_scope,
                                   compute_dtype, dense, embed_scale, mlp,
                                   normal_, param,
                                   sinusoidal_positions_dynamic, weight_dtype)


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return cfg.ffn != "none" and kind in FFN_MIXERS


# a dense feed-forward goes over a call's tokens in groups of this many
# when there are more, as the MoE layers do (the hidden (T, d_ff)
# products of one group only are live)
FFN_TOKENS = 131_072


def _dense_config(cfg: ModelConfig) -> ModelConfig:
    """The config a dense first layer of an MoE model runs its SwiGLU
    with; any other model's own."""
    return _swiglu_config(cfg) if cfg.ffn == "moe" else cfg


def _dense_ffn(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense feed-forward of (B, S, D), over the tokens in groups of
    at most ``FFN_TOKENS``."""
    dcfg = _dense_config(cfg)
    if h.shape[0] * h.shape[1] <= FFN_TOKENS:
        return mlp(p, h, dcfg)
    flat = h.reshape(-1, h.shape[-1])
    return torch.cat([mlp(p, flat[lo:lo + FFN_TOKENS], dcfg)
                      for lo in range(0, flat.shape[0], FFN_TOKENS)]
                     ).view(h.shape)


@functools.lru_cache(maxsize=16)
def _swiglu_config(cfg: ModelConfig) -> ModelConfig:
    # made once per config: a decode step asks in every dense layer
    return dataclasses.replace(cfg, ffn="swiglu")


# ------------------------------------------------------------------ modules
class Block(nn.Module):
    """norm1 -> mixer -> residual, then norm2 -> ffn -> residual. With
    ``cfg.sandwich_norm`` the mixer's output passes ``post1`` and the
    ffn's ``post2`` before their residual adds."""

    def __init__(self, cfg: ModelConfig, kind: str, device,
                 trainable: bool = False, layer: int = 0):
        super().__init__()
        t = trainable
        self.norm1 = Norm(cfg.d_model, cfg.norm, device, t)
        if kind in ATTN_KINDS:
            self.mixer = attn.Attention(cfg, device, t)
        elif kind == "mla":
            self.mixer = mla_mod.MLA(cfg, device, t)
        elif kind == "rglru":
            self.mixer = rec.RGLRU(cfg, device, t)
        elif kind == "mlstm":
            self.mixer = rec.MLSTM(cfg, device, t)
        elif kind == "slstm":
            self.mixer = rec.SLSTM(cfg, device, t)
        else:
            raise ValueError(kind)
        if cfg.sandwich_norm:
            self.post1 = Norm(cfg.d_model, cfg.norm, device, t)
        if _has_ffn(cfg, kind):
            self.norm2 = Norm(cfg.d_model, cfg.norm, device, t)
            self.ffn = (moe_mod.MoE(cfg, device, t, layer)
                        if cfg.ffn_kind(layer) == "moe"
                        else MLP(_dense_config(cfg), device, t))
            if cfg.sandwich_norm:
                self.post2 = Norm(cfg.d_model, cfg.norm, device, t)


class Transformer(nn.Module):
    """Parameters of the whole model, uninitialised (see
    :func:`init_params` and ``models/params.py``). ``device="meta"`` gives
    the shapes without memory. ``trainable``: float32 master weights with
    ``requires_grad`` (training), else bf16 frozen weights on a card
    (serving). A frames model has no ``embed``."""

    def __init__(self, cfg: ModelConfig, device, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        t = trainable
        wd = weight_dtype(cfg, device, t)
        if cfg.embed_mode == "tokens":
            self.embed = param((cfg.vocab_size, cfg.d_model), wd, device,
                               trainable=t)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), wd, device,
                             trainable=t)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device, t)
        n = len(cfg.pattern)
        self.units = nn.ModuleList(
            nn.ModuleDict({f"b{i}": Block(cfg, kind, device, t, u * n + i)
                           for i, kind in enumerate(cfg.pattern)})
            for u in range(cfg.num_units))
        for i, kind in enumerate(cfg.tail_pattern):
            self.add_module(f"tail{i}", Block(cfg, kind, device, t,
                                              cfg.num_units * n + i))

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def blocks(self):
        """(block, kind) in layer order."""
        for unit in self.units:
            for i, kind in enumerate(self.cfg.pattern):
                yield unit[f"b{i}"], kind
        for i, kind in enumerate(self.cfg.tail_pattern):
            yield getattr(self, f"tail{i}"), kind


# weights the reference initialises from N(0, 0.02); the rest are constants
_RANDOM = {"embed", "lm_head", "wq", "wk", "wv", "wo", "wkva", "wkvb",
           "in_x", "in_gate",
           "w", "w_ig", "w_rg", "out", "w1", "w2", "w3", "router", "up",
           "w_if", "down", "w_gates", "r_gates", "up1", "up2"}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, trainable: bool = False) -> Transformer:
    """A model with random weights drawn from ``generator`` (on
    ``device``). The bits differ from the reference's ``jax.random``
    draws; carry the reference's weights across with
    ``models.params.from_reference`` where they must agree."""
    model = Transformer(cfg, device, trainable)
    for name, t in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _RANDOM:
            normal_(t.data, generator)
    return model


# -------------------------------------------------------------- block forward
def _mixer_residual(p: Block, x, h, cfg: ModelConfig):
    if cfg.sandwich_norm:
        h = apply_norm(p.post1, h, cfg.norm)
    return x + h


def _ffn_residual(p: Block, x, cfg: ModelConfig, kind: str):
    """norm2 -> ffn -> residual: (x, the MoE aux loss, or None for a block
    without an MoE feed-forward)."""
    aux = None
    if _has_ffn(cfg, kind):
        h = apply_norm(p.norm2, x, cfg.norm)
        if isinstance(p.ffn, moe_mod.MoE):
            h, aux = moe_mod.moe_forward(p.ffn, h, cfg)
        else:
            h = _dense_ffn(p.ffn, h, cfg)
        if cfg.sandwich_norm:
            h = apply_norm(p.post2, h, cfg.norm)
        x = x + h
    return x, aux


def _add_aux(total, aux):
    """A running sum of block aux losses, None where no block gave one."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def apply_block(p: Block, x, cfg: ModelConfig, kind: str, positions,
                use_kernel=None, capacity=None):
    """One layer: (B, S, D) -> ((B, S, D), cache, aux). With ``capacity``
    the cache is the block's decode cache at the prompt's end (attention
    caches padded to ``capacity``), else None; aux is the block's MoE
    load-balancing loss, None without one. The reference's
    ``_apply_block`` and ``_prefill_block`` in one."""
    h = apply_norm(p.norm1, x, cfg.norm)
    cache = None
    if kind == "mla":
        out = mla_mod.mla_forward(p.mixer, h, cfg, positions, capacity,
                                  use_kernel)
        h, cache = out if capacity is not None else (out, None)
    elif kind in ATTN_KINDS:
        if capacity is None:
            h = attn.attn_forward(p.mixer, h, cfg, kind, positions,
                                  use_kernel=use_kernel)
        else:
            h, kv = attn.attn_forward(p.mixer, h, cfg, kind, positions,
                                      return_kv=True, use_kernel=use_kernel)
            pad = capacity - x.shape[1]
            cache = {"k": F.pad(kv["k"], (0, 0, 0, pad)),
                     "v": F.pad(kv["v"], (0, 0, 0, pad))}
    else:
        state = capacity is not None
        if kind == "rglru":
            out = rec.rglru_forward(p.mixer, h, cfg, use_kernel=use_kernel,
                                    return_state=state)
        elif kind == "mlstm":
            out = rec.mlstm_forward(p.mixer, h, cfg, return_state=state)
        else:
            out = rec.slstm_forward(p.mixer, h, cfg, return_state=state)
        h, cache = out if state else (out, None)
    x, aux = _ffn_residual(p, _mixer_residual(p, x, h, cfg), cfg, kind)
    return x, cache, aux


def embed_inputs(model: Transformer, cfg: ModelConfig, inputs, positions):
    """(B, S) token ids through the embedding table, or (B, S, D) frames
    cast to the compute dtype; then the embedding scale and sinusoidal
    positions where the config asks for them."""
    dt = compute_dtype(model.device)
    if cfg.embed_mode == "tokens":
        x = F.embedding(inputs.long(), model.embed).to(dt)
    else:
        x = inputs.to(dt)
    if cfg.scale_embeddings:
        x = x * embed_scale(cfg.d_model, dt)
    if cfg.pos_emb == "sinusoidal":
        B, S = positions.shape
        pe = sinusoidal_positions_dynamic(positions.reshape(-1), cfg.d_model)
        x = x + pe.reshape(B, S, cfg.d_model).to(getattr(torch, cfg.dtype))
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


# cfg.remat == "dots" saves the outputs of the matrix products (the
# reference's jax.checkpoint_policies.checkpoint_dots) and recomputes the
# rest
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg: ModelConfig) -> dict:
    if cfg.remat == "dots":
        return {"context_fn": lambda: create_selective_checkpoint_contexts(
            _save_dots)}
    return {}


def forward(model: Transformer, cfg: ModelConfig, inputs, positions,
            use_kernel=None):
    """Body -> (hidden (B, S, D), aux). aux is the MoE load-balancing loss
    summed over the blocks and divided by the number of blocks with a
    feed-forward (the reference's mean); 0 without MoE. With grad enabled and
    ``cfg.remat`` "full" each unit runs under ``torch.utils.checkpoint``
    (its activations are recomputed in the backward; "dots" keeps the
    matrix products' outputs); "none", the tail blocks and a forward
    without grad keep everything."""
    x = embed_inputs(model, cfg, inputs, positions)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    bwd16 = bf16_backward_enabled()

    def unit_step(x, unit):
        # the recompute runs in the backward, outside the caller's scope
        aux = None
        with bf16_backward_scope(bwd16):
            for i, kind in enumerate(cfg.pattern):
                x, _, a = apply_block(unit[f"b{i}"], x, cfg, kind, positions,
                                      use_kernel)
                aux = _add_aux(aux, a)
        return x, aux

    total = None
    for unit in model.units:
        if remat:
            x, a = checkpoint(unit_step, x, unit, use_reentrant=False,
                              **_remat_kwargs(cfg))
        else:
            x, a = unit_step(x, unit)
        total = _add_aux(total, a)
    for i, kind in enumerate(cfg.tail_pattern):
        x, _, a = apply_block(getattr(model, f"tail{i}"), x, cfg, kind,
                              positions, use_kernel)
        total = _add_aux(total, a)
    x = apply_norm(model.final_norm, x, cfg.norm)
    if total is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    n_ffn = sum(_has_ffn(cfg, k) for k in
                list(cfg.pattern) * cfg.num_units + list(cfg.tail_pattern))
    return x, total / max(n_ffn, 1)


def logits_fn(model: Transformer, cfg: ModelConfig, hidden):
    logits = dense(hidden, model.lm_head).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ------------------------------------------------------------------- caches
def _block_cache(cfg: ModelConfig, kind: str, batch, capacity, device):
    if kind in ATTN_KINDS:
        return attn.init_kv_cache(cfg, batch, capacity, device)
    if kind == "mla":
        return mla_mod.init_latent_cache(cfg, batch, capacity, device)
    if kind == "rglru":
        return rec.init_rglru_cache(cfg, batch, device)
    if kind == "mlstm":
        return rec.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return rec.init_slstm_cache(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch, capacity, device):
    """{"units": [one dict per unit, {"b{i}": block cache}], "tail{i}": ...}
    (the reference stacks the unit caches on a leading axis)."""
    cache = {"units": [{f"b{i}": _block_cache(cfg, kind, batch, capacity,
                                              device)
                        for i, kind in enumerate(cfg.pattern)}
                       for _ in range(cfg.num_units)]}
    for i, kind in enumerate(cfg.tail_pattern):
        cache[f"tail{i}"] = _block_cache(cfg, kind, batch, capacity, device)
    return cache


def prefill(model: Transformer, cfg: ModelConfig, inputs, capacity=None,
            use_kernel=None):
    """Run the full prompt ((B, S) tokens or (B, S, D) frames), return
    (last-position logits (B, 1, V), decode cache)."""
    B, S = inputs.shape[:2]
    capacity = capacity or S
    positions = _positions(B, S, model.device)
    x = embed_inputs(model, cfg, inputs, positions)
    caches = []
    for block, kind in model.blocks():
        x, c, _ = apply_block(block, x, cfg, kind, positions, use_kernel,
                              capacity)
        caches.append(c)
    x = apply_norm(model.final_norm, x, cfg.norm)
    return logits_fn(model, cfg, x[:, -1:]), _nest(cfg, caches)


def _nest(cfg: ModelConfig, per_layer: list) -> dict:
    """Per-layer caches (layer order) -> the structure of init_cache."""
    n = len(cfg.pattern)
    cache = {"units": [{f"b{i}": per_layer[u * n + i] for i in range(n)}
                       for u in range(cfg.num_units)]}
    for i in range(len(cfg.tail_pattern)):
        cache[f"tail{i}"] = per_layer[cfg.num_units * n + i]
    return cache


def layer_caches(cfg: ModelConfig, cache: dict) -> list:
    """The per-layer caches of ``cache``, in layer order."""
    out = [unit[f"b{i}"] for unit in cache["units"]
           for i in range(len(cfg.pattern))]
    return out + [cache[f"tail{i}"] for i in range(len(cfg.tail_pattern))]


def _decode_block(p: Block, c, x, cfg: ModelConfig, kind: str, pos: int):
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in ATTN_KINDS:
        h, c = attn.attn_decode(p.mixer, h, cfg, kind, c, pos)
    elif kind == "mla":
        h, c = mla_mod.mla_decode(p.mixer, h, cfg, c, pos)
    else:
        decode = {"rglru": rec.rglru_decode, "mlstm": rec.mlstm_decode,
                  "slstm": rec.slstm_decode}[kind]
        h, c = decode(p.mixer, h, cfg, c)
    x, _ = _ffn_residual(p, _mixer_residual(p, x, h, cfg), cfg, kind)
    return x, c


def decode_step(model: Transformer, cfg: ModelConfig, cache, inputs,
                pos: int):
    """One decode step. inputs: (B, 1) tokens or (B, 1, D) frames; pos:
    int. Returns (logits
    (B, 1, V), new cache). Attention caches are updated in place."""
    B = inputs.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=model.device)
    x = embed_inputs(model, cfg, inputs, positions)
    new = []
    for (block, kind), c in zip(model.blocks(), layer_caches(cfg, cache)):
        x, c = _decode_block(block, c, x, cfg, kind, pos)
        new.append(c)
    x = apply_norm(model.final_norm, x, cfg.norm)
    return logits_fn(model, cfg, x), _nest(cfg, new)
