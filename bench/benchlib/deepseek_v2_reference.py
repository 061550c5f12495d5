"""The plain reference of DeepSeek-V2 (the published
``DeepseekV2ForCausalLM``, without a q LoRA), in float32 PyTorch.

Per layer: an RMSNorm; multi-head latent attention, decompressed: q = x
W_q split into q_nope and q_pe; [c, k_pe] = x W_kva, c RMSNorm-ed; [k_nope,
v] = c W_kvb per head; q_pe and k_pe (one head for all) rotated by YaRN's
rotary embedding in the published layout (each vector's even and odd
entries gathered into halves, then rotated as halves: the rotation of the
pairs (2i, 2i+1) at frequency i); scores (q_nope . k_nope + q_pe . k_pe)
times (qk_nope + qk_rope)^-1/2 times mscale(factor, mscale_all_dim)^2, a
causal softmax, P v and W_o; the residual add. Then an RMSNorm and the
feed-forward: in the first ``first_k_dense_replace`` layers a SwiGLU
(``down(silu(gate(x)) * up(x))``), in the rest DeepSeekMoE: a float32
softmax over the routed experts, the top ``num_experts_per_tok`` (greedy,
ties to the lower index), their probabilities as weights (renormalised
only with ``norm_topk_prob``) times ``routed_scaling_factor``, each chosen
expert's SwiGLU on its tokens, weighted and summed, plus the shared
experts' SwiGLU; the residual add. A final RMSNorm and the untied LM head.

Every product runs in float32 with TF32 off, on the weights
``deepseek_v2_weights.py`` draws from the seed (matrices rounded to the
weight dtype the program serves), one layer at a time, attention in
blocks of queries. No absorption, cache or kernel: each call takes whole
token sequences.

**Routing is replayed.** Given the program's expert ids (``routes``, per
MoE layer and position), the reference computes those experts, weighted
by its own probabilities, so that a choice the program's rounding moved
across the top-k boundary does not make the two models differ wholesale.
It reports how often the given choices differ from its own top-k
(``route_flip_share``: choices outside its own top-k over all choices)
and by how much (``route_flip_gap``: the largest probability by which a
given choice lies below its own k-th best). Without ``routes`` it routes
itself.

Departures from the published description, each the parametrisation or
the precision of a table only: an RMSNorm's weight is ``1 + scale``; the
rotary tables are computed in float64 and rounded once.

With ``bits`` set, the control: the same pass with each attention
probability matrix P and each layer's output rounded to ``bits``
significant bits (``model_reference.round_to_bits``).

This module imports nothing of the program, JAX or the JAX package.
"""
from __future__ import annotations

import math

import torch

from benchlib import deepseek_v2_weights as dw
from benchlib.model_reference import round_to_bits

QUERY_BLOCK = 256


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(config: dict, device) -> torch.Tensor:
    """YaRN's (rope / 2,) inverse frequencies in float64
    (``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base = config["qk_rope_head_dim"], float(config["rope_theta"])
    y = config["rope_scaling"]
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                       device=device) / dim)

    def corr(rot):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    return freq / y["factor"] * ramp + freq * (1 - ramp)


def softmax_scale(config: dict) -> float:
    y = config["rope_scaling"]
    m = _mscale(y["factor"], y["mscale_all_dim"])
    return (config["qk_nope_head_dim"] + config["qk_rope_head_dim"]) \
        ** -0.5 * m * m


def _rope_tables(config: dict, T: int, device):
    y = config["rope_scaling"]
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] \
        * yarn_inv_freq(config, device)
    emb = torch.cat([ang, ang], dim=-1)
    f = _mscale(y["factor"], y["mscale"]) / _mscale(y["factor"],
                                                    y["mscale_all_dim"])
    return (torch.cos(emb) * f).float(), (torch.sin(emb) * f).float()


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb``: x (..., T, d) with its even
    entries gathered before its odd ones, then rotated as halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q, k, v, scale, bits):
    """Causal softmax attention, q, k (N, H, T, dqk), v (N, H, T, dv), in
    blocks of queries."""
    T = q.shape[2]
    out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype,
                      device=q.device)
    pos = torch.arange(T, device=q.device)
    for lo in range(0, T, QUERY_BLOCK):
        hi = min(T, lo + QUERY_BLOCK)
        s = torch.matmul(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) \
            * scale
        s.masked_fill_(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        if bits:
            round_to_bits(p, bits)
        out[:, :, lo:hi] = torch.matmul(p, v[:, :, :hi])
        del p
    return out


def _mla(h, w: dict, config: dict, cos, sin, bits, latent_from: int):
    """(output, [c, k_pe] (N, T - latent_from, R + Rp) at the positions
    from ``latent_from``, k_pe in the published layout)."""
    s = dw.shape_of(config)
    N, T, _ = h.shape
    H, r, nope, v_dim = s["h"], s["r"], s["nope"], s["v"]
    q = (h @ w["mixer.wq"]).view(N, T, H, -1).transpose(1, 2)
    kva = h @ w["mixer.wkva"]
    c = _rms(kva[..., :r], w["mixer.kv_norm"], config["rms_norm_eps"])
    k_pe = _rope(kva[..., r:], cos, sin)                    # (N, T, Rp)
    latent = torch.cat([c[:, latent_from:], k_pe[:, latent_from:]], dim=-1)
    kv = (c @ w["mixer.wkvb"]).view(N, T, H, -1).transpose(1, 2)
    del kva, c
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe[:, None].expand(-1, H, -1, -1)],
                  dim=-1)
    a = _attention(q, k, kv[..., nope:], softmax_scale(config), bits)
    del q, k, kv
    return a.transpose(1, 2).reshape(N, T, H * v_dim) @ w["mixer.wo"], \
        latent


def _swiglu(h, w1, w3, w2):
    return (torch.nn.functional.silu(h @ w1) * (h @ w3)) @ w2


def _moe(h, w: dict, config: dict, ids):
    """(output, the expert ids used (N, T, K), flips, gap): ``ids`` the
    replayed choices, or None to route by its own top-k."""
    s = dw.shape_of(config)
    N, T, D = h.shape
    K = s["k"]
    probs = torch.softmax(h @ w["ffn.router"], dim=-1)      # (N, T, E)
    own_p, own = torch.sort(probs, dim=-1, descending=True, stable=True)
    own_p, own = own_p[..., :K], own[..., :K]
    if ids is None:
        ids = own
    ids = ids.long()
    chosen = probs.gather(-1, ids)
    flips = int((ids[..., :, None] != own[..., None, :]).all(-1).sum())
    gap = float((own_p[..., -1:] - chosen).clamp(min=0).max())
    weight = chosen
    if config["norm_topk_prob"]:
        weight = weight / weight.sum(-1, keepdim=True)
    weight = weight * config["routed_scaling_factor"]
    flat, wflat, iflat = h.reshape(-1, D), weight.reshape(-1), ids.reshape(-1)
    y = torch.zeros_like(flat)
    for e in range(s["e"]):
        slot = (iflat == e).nonzero()[:, 0]
        if not slot.numel():
            continue
        tok = slot // K
        ye = _swiglu(flat[tok], w["ffn.w1"][e], w["ffn.w3"][e],
                     w["ffn.w2"][e])
        y.index_add_(0, tok, ye * wflat[slot, None])
    y = y.view(N, T, D) + _swiglu(h, w["ffn.shared.w1"], w["ffn.shared.w3"],
                                  w["ffn.shared.w2"])
    return y, ids, flips, gap


def run(config: dict, seed: int, tokens: torch.Tensor, first: int, *,
        routes: torch.Tensor | None = None, bits: int | None = None,
        latent_from: int | None = None) -> dict:
    """The reference over the (N, T) token sequences ``tokens`` on their
    device: ``logits`` (N, T - first, vocab) at positions ``first`` ..
    T-1; ``routes`` (MoE layers, N, T, top_k), the expert ids it computed
    (``routes`` replayed, or its own); ``route_flip_share`` and
    ``route_flip_gap`` of those ids against its own routing; ``latent``
    (layers, N, T - latent_from, R + Rp), each layer's normed latent and
    rotated k_pe (the published layout: even entries, then odd) at the
    positions from ``latent_from`` (default ``first + 1``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = tokens.device
    s = dw.shape_of(config)
    eps = config["rms_norm_eps"]
    T = tokens.shape[1]
    used, latents, flips, gap = [], [], 0, 0.0
    latent_from = first + 1 if latent_from is None else latent_from
    with torch.no_grad():
        embed = dw.draw(config, seed, "embed", (s["vocab"], s["d"]),
                        "matrix", dev)
        x = embed[tokens.long()].float()
        del embed
        cos, sin = _rope_tables(config, T, dev)
        for u in range(s["layers"]):
            w = dw.layer(config, seed, u, dev)
            a, lat = _mla(_rms(x, w["norm1.scale"], eps), w, config, cos,
                          sin, bits, latent_from)
            x = x + a
            latents.append(lat)
            del a
            h = _rms(x, w["norm2.scale"], eps)
            if u < s["dense"]:
                x = x + _swiglu(h, w["ffn.w1"], w["ffn.w3"], w["ffn.w2"])
            else:
                m = u - s["dense"]
                y, ids, f, g = _moe(h, w, config,
                                    None if routes is None else routes[m])
                x = x + y
                used.append(ids)
                flips, gap = flips + f, max(gap, g)
            del w, h
            if bits:
                round_to_bits(x, bits)
        scale = dw.draw(config, seed, "final_norm.scale", (s["d"],), "norm",
                        dev)
        h = _rms(x[:, first:], scale, eps)
        del x
        head = dw.draw(config, seed, "lm_head", (s["d"], s["vocab"]),
                       "matrix", dev).float()
        routes_used = torch.stack(used)
        return {"logits": h @ head, "routes": routes_used,
                "route_flip_share": flips / routes_used.numel(),
                "route_flip_gap": gap, "latent": torch.stack(latents)}
