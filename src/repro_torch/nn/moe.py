"""Mixture-of-Experts FFN with top-k routing; the port of ``repro/nn/moe.py``.

Two implementations, selectable via ``cfg.moe_impl``:

* ``dense``    — every expert computes every token, outputs combined with the
  (mostly-zero) routing weights. Exactly differentiable, no token dropping,
  E/top_k times the FLOPs of the tokens' own experts.
* ``dropping`` — capacity-bounded gather/scatter dispatch (Switch-style):
  each expert processes at most C = ceil(T/E · top_k · capacity_factor)
  tokens, selected by routing weight.

Neither holds a kernel of the reference's: the products are batched matrix
products (cuBLAS on a card), the selection a sort and the combine an
``index_add``. The reference's ``constrain`` mesh hints (the group axis on
the data shards) have no counterpart on one device and are dropped.

Numerics. The router is float32 in every model, serving ones on a card
included, and the routing runs in float32 from ``x`` cast to float32, as
the reference's ``x.astype(f32) @ router``: a bf16 router would move tokens
across the top-k boundary. The expert weights follow ``weight_dtype`` (the
compute dtype for serving on a card, as the reference's ``astype(x.dtype)``
before every product). The expert FFN (:func:`_expert_ffn`) takes each
product in the compute dtype with float32 accumulation, as the port's
``dense`` does: on the CPU (float32) the reference's rounding points are
kept exactly; on a card the up-projections round once to bf16 before the
float32 ``silu(h) * h3`` where the reference keeps them in float32, the
choice ``nn.layers.mlp`` makes for the dense feed-forwards. ``h * h3`` is
rounded to the compute dtype and the down-projection accumulates in float32
and rounds once, as in the reference; ``moe_dense`` combines in float32 and
rounds once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import param, weight_dtype


class MoE(nn.Module):
    """``router`` (D, E) float32; ``w1``, ``w3`` (E, D, F) and ``w2`` (E, F,
    D) in ``weight_dtype``."""

    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d, e = cfg.d_model, cfg.n_experts
        ffe = cfg.d_ff_expert or cfg.d_ff
        wd = weight_dtype(cfg, device, trainable)
        t = trainable
        self.router = param((d, e), torch.float32, device, trainable=t)
        self.w1 = param((e, d, ffe), wd, device, trainable=t)
        self.w3 = param((e, d, ffe), wd, device, trainable=t)
        self.w2 = param((e, ffe, d), wd, device, trainable=t)


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of each row of ``x`` and their indices, ties
    to the lower index, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties): a stable descending sort, cut to k."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _routing(p: MoE, x: torch.Tensor, cfg):
    """x: (T, D) -> (combine (T, E) with zeros off the top-k, top_idx (T, K),
    top_w (T, K), aux). aux is the Switch load-balancing loss
    E * sum_e f_e * pbar_e: f_e, the share of routed slots, comes from the
    one-hot and carries no gradient; pbar_e, the mean probability, does."""
    logits = x.float() @ p.router                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = _top_k(probs, cfg.top_k)                 # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_idx, cfg.n_experts).float()        # (T, K, E)
    combine = (onehot * top_w[..., None]).sum(dim=1)          # (T, E)
    f = onehot.sum(dim=1).mean(dim=0)
    pbar = probs.mean(dim=0)
    aux = cfg.n_experts * torch.sum(f * pbar)
    return combine, top_idx, top_w, aux


def _expert_ffn(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """Batched-over-experts gated FFN. x: (E, C, D) -> (E, C, D) in x's
    dtype (see the module's numerics)."""
    dt = x.dtype
    h = F.silu(torch.matmul(x, p.w1.to(dt)).float())
    h3 = torch.matmul(x, p.w3.to(dt)).float()
    h = (h * h3).to(dt)
    return torch.matmul(h, p.w2.to(dt))


def moe_dense(p: MoE, x: torch.Tensor, cfg):
    """x: (B, S, D). Every expert computes every token."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    combine, _, _, aux = _routing(p, xt, cfg)
    ye = _expert_ffn(p, xt.expand(cfg.n_experts, B * S, D))     # (E, T, D)
    y = torch.einsum("etd,te->td", ye.float(), combine)
    return y.reshape(B, S, D).to(x.dtype), aux


def dispatch(combine: torch.Tensor, cfg):
    """The dropping path's selection from ``combine`` (T, E): G groups of
    Tl = T / G tokens (``cfg.moe_groups`` when it is over 1 and divides T,
    else one group), capacity C = min(ceil(Tl / E * top_k *
    capacity_factor), Tl), and per group and expert the C tokens of largest
    weight. Returns (sel_w, sel_idx), each (G, E, C); sel_idx indexes the
    group's tokens."""
    T, E = combine.shape
    G = cfg.moe_groups if cfg.moe_groups > 1 and T % cfg.moe_groups == 0 \
        else 1
    Tl = T // G
    C = int(math.ceil(Tl / E * cfg.top_k * cfg.capacity_factor))
    C = min(C, Tl)
    return _top_k(combine.reshape(G, Tl, E).transpose(1, 2), C)


def moe_dropping(p: MoE, x: torch.Tensor, cfg):
    """Capacity-bounded dispatch: per group of tokens (``cfg.moe_groups``
    when it divides T, else one), each expert takes the C tokens of largest
    routing weight (ties to the lower token index, as the reference's
    ``top_k``; an expert routed fewer than C tokens fills its slots with
    tokens of weight 0), runs its FFN on them and adds them back scaled by
    their weight, in float32.

    The add is ``index_add``, which on a card takes atomics. It is still
    bit-stable: with ``top_k`` 2 a token row receives at most two nonzero
    terms (its two experts; every filler slot adds an exact +-0) onto +0,
    and a sum of two terms does not depend on their order. A config with
    ``top_k`` > 2 would lose that."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    combine, _, _, aux = _routing(p, xt, cfg)                 # (T, E)
    sel_w, sel_idx = dispatch(combine, cfg)                   # (G, E, C)
    G, E, C = sel_idx.shape
    # expert-major, so that one batched product per weight serves every
    # group: (E, G * C) slots, each the row of the (T, D) tokens it holds
    # (group g's token i is row g * T / G + i)
    rows = (sel_idx + (T // G) * torch.arange(G, device=x.device)[
        :, None, None]).transpose(0, 1).reshape(-1)
    w = sel_w.transpose(0, 1).reshape(E, G * C, 1)
    xg = xt.index_select(0, rows).reshape(E, G * C, D)
    yg = _expert_ffn(p, xg).float() * w                       # (E, G*C, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    y = y.index_add(0, rows, yg.reshape(-1, D))
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_forward(p: MoE, x: torch.Tensor, cfg):
    if cfg.moe_impl == "dropping":
        return moe_dropping(p, x, cfg)
    return moe_dense(p, x, cfg)
