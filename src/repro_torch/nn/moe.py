"""Mixture-of-Experts FFN with top-k routing; the port of ``repro/nn/moe.py``.

Three implementations, selectable via ``cfg.moe_impl``:

* ``dense``    — every expert computes every token, outputs combined with the
  (mostly-zero) routing weights. Exactly differentiable, no token dropping,
  E/top_k times the FLOPs of the tokens' own experts.
* ``dropping`` — capacity-bounded gather/scatter dispatch (Switch-style):
  each expert processes at most C = ceil(T/E · top_k · capacity_factor)
  tokens, selected by routing weight.
* ``dropless`` — the port's own (the reference has none): every routed
  slot is computed. The T x top_k slots are sorted by expert and each
  weight matrix is one grouped product over the experts' runs of slots
  (``torch._grouped_mm`` on a card; a loop over the experts elsewhere),
  then each token's slots are weighted and summed in float32 in slot
  order. With ``cfg.n_shared_experts`` a SwiGLU of ``n_shared_experts x
  d_ff_expert`` that every token takes is added (DeepSeekMoE). Nothing
  in it waits on the device: the experts' run lengths stay on the card.
  Tokens go through in groups of ``DROPLESS_TOKENS``, so that the slot
  buffers of one group only are live. A call of at most ``FEW_TOKENS``
  tokens (a decode step) takes every expert over all its tokens in three
  batched products instead, the unrouted pairs weighted by zero: the
  products then read the same expert weights (a step's slots touch most
  experts), and the sort and the grouped launches would cost more host
  time than the card spends. Each call is a ``Model.moe`` span
  with attributes ``tokens`` and ``slots``, adds its slots per expert to
  the module's ``load`` counter (an (E,) int64 tensor on the module's
  device, which the caller zeroes and reads between calls), and hands
  its expert ids (B, S, top_k) to the module's ``route_hook`` where one
  is installed (:func:`install_route_hook`).

The dense and dropping dispatches hold no kernel of the reference's: the
products are batched matrix products (cuBLAS on a card), the selection a
sort and the combine an ``index_add``. The reference's ``constrain`` mesh hints (the group axis on
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

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.nn.layers import MLP, mlp, param, weight_dtype

DROPLESS_TOKENS = 32_768    # tokens of one group of the dropless dispatch
FEW_TOKENS = 64             # at most this many: every expert, every token


@functools.lru_cache(maxsize=16)
def shared_config(cfg):
    """The config of the shared experts' SwiGLU: ``n_shared_experts x
    d_ff_expert`` wide (made once per config: a decode step asks in every
    MoE layer)."""
    return dataclasses.replace(
        cfg, ffn="swiglu", d_ff=cfg.n_shared_experts * cfg.d_ff_expert)


class MoE(nn.Module):
    """``router`` (D, E) float32; ``w1``, ``w3`` (E, D, F) and ``w2`` (E, F,
    D) in ``weight_dtype``; with ``cfg.n_shared_experts`` the ``shared``
    SwiGLU. ``layer`` is the block's index in the model, for the route
    hook."""

    def __init__(self, cfg, device, trainable: bool = False,
                 layer: int = 0):
        super().__init__()
        d, e = cfg.d_model, cfg.n_experts
        ffe = cfg.d_ff_expert or cfg.d_ff
        wd = weight_dtype(cfg, device, trainable)
        t = trainable
        self.layer = layer
        self.route_hook = None
        self.router = param((d, e), torch.float32, device, trainable=t)
        self.w1 = param((e, d, ffe), wd, device, trainable=t)
        self.w3 = param((e, d, ffe), wd, device, trainable=t)
        self.w2 = param((e, ffe, d), wd, device, trainable=t)
        if cfg.n_shared_experts:
            self.shared = MLP(shared_config(cfg), device, t)
        self.register_buffer("load", torch.zeros(e, dtype=torch.int64,
                                                 device=device),
                             persistent=False)


def install_route_hook(model: nn.Module, hook) -> None:
    """Hand ``hook(layer, ids)`` every dropless MoE call's expert ids
    (B, S, top_k), a device tensor, in ``model``; None takes it away."""
    for m in model.modules():
        if isinstance(m, MoE):
            m.route_hook = hook


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


def _dropless_routing(p: MoE, x: torch.Tensor, cfg):
    """x: (T, D) -> (top_w (T, K) float32, top_idx (T, K), probs (T, E)):
    a float32 softmax over the experts, the top k (ties to the lower
    index), the weights renormalised over them only with
    ``cfg.norm_topk_prob``."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    top_w, top_idx = _top_k(probs, cfg.top_k)
    if cfg.norm_topk_prob:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_idx, probs


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (M, K) in runs by expert (run e ends at ``offs[e]``)
    times ``w[e]`` (E, K, N): (M, N) in x's dtype, float32 accumulation."""
    if x.is_cuda:
        return torch._grouped_mm(x, w.to(x.dtype), offs=offs)
    return torch.cat([xe @ we.to(x.dtype) for xe, we in
                      zip(torch.split(x, counts.tolist()), w)])


def _routed(p: MoE, x: torch.Tensor, top_w: torch.Tensor,
            top_idx: torch.Tensor, n_experts: int):
    """The routed experts' weighted sum for the tokens x (T, D): (float32
    (T, D), slots per expert (E,))."""
    T, K = top_idx.shape
    flat = top_idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices           # by expert
    counts = torch.zeros(n_experts, dtype=torch.int64, device=x.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = x.index_select(0, order // K)
    dt = x.dtype
    h = F.silu(_grouped(xs, p.w1, offs, counts).float()) \
        * _grouped(xs, p.w3, offs, counts).float()
    del xs
    ys = _grouped(h.to(dt), p.w2, offs, counts)
    del h
    back = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=x.device))
    yk = ys.index_select(0, back).view(T, K, -1).float()
    return (yk * top_w[..., None]).sum(dim=1), counts


def _routed_few(p: MoE, x: torch.Tensor, top_w: torch.Tensor,
                top_idx: torch.Tensor, n_experts: int):
    """``_routed`` for a few tokens: every expert's products over all of
    them (``_expert_ffn``), combined with the routing weights (zero off
    the top k) in float32."""
    T, D = x.shape
    combine = torch.zeros((T, n_experts), dtype=torch.float32,
                          device=x.device).scatter_(1, top_idx, top_w)
    ye = _expert_ffn(p, x.expand(n_experts, T, D))           # (E, T, D)
    flat = top_idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=x.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    return torch.einsum("etd,te->td", ye.float(), combine), counts


def moe_dropless(p: MoE, x: torch.Tensor, cfg):
    """x: (B, S, D). Every routed slot computed, plus the shared experts
    (see the module's docstring)."""
    B, S, D = x.shape
    T, K = B * S, cfg.top_k
    xt = x.reshape(T, D)
    with trace.span("Model.moe", tokens=T, slots=T * K):
        top_w, top_idx, probs = _dropless_routing(p, xt, cfg)
        if p.route_hook is not None:
            p.route_hook(p.layer, top_idx.view(B, S, K))
        y = torch.empty_like(xt)
        routed = _routed_few if T <= FEW_TOKENS else _routed
        counts = None
        for lo in range(0, T, DROPLESS_TOKENS):
            hi = min(T, lo + DROPLESS_TOKENS)
            out, c = routed(p, xt[lo:hi], top_w[lo:hi], top_idx[lo:hi],
                            cfg.n_experts)
            counts = c if counts is None else counts + c
            if cfg.n_shared_experts:
                out += mlp(p.shared, xt[lo:hi], shared_config(cfg)).float()
            y[lo:hi] = out.to(x.dtype)
        p.load += counts
        aux = torch.dot(counts.float(), probs.mean(dim=0)) \
            * (cfg.n_experts / T)
    return y.reshape(B, S, D), aux


def moe_forward(p: MoE, x: torch.Tensor, cfg):
    if cfg.moe_impl == "dropping":
        return moe_dropping(p, x, cfg)
    if cfg.moe_impl == "dropless":
        return moe_dropless(p, x, cfg)
    return moe_dense(p, x, cfg)
