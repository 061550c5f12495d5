"""The plain reference of a Qwen2 decoder, in float32 PyTorch.

The forward pass of the published Qwen2 architecture (Hugging Face's
``Qwen2ForCausalLM``): the token embedding; per layer an RMSNorm, grouped
query attention with biases on q, k and v, rotary embeddings (the
half-rotation layout, ``rope_theta``) and a causal softmax, the output
projection and the residual add, then an RMSNorm, the SwiGLU feed-forward
(``down(silu(gate(x)) * up(x))``) and the residual add; a final RMSNorm
and the untied LM head. Every product runs in float32 with TF32 off, on
the weights ``model_weights.py`` draws from the seed (matrices rounded to
the configuration's weight dtype, which is what the program serves), one
layer at a time, so the whole model never sits on the card at once. No
kernel, cache or batching trick: each call takes whole token sequences.

Departures from the published description, each the parametrisation
only: an RMSNorm's weight is ``1 + scale`` (the port's names hold the
offset); the rotary table is computed in float64 and rounded once.

With ``bits`` set, the control: the same pass with each attention
probability matrix P and each layer's output rounded to ``bits``
significant bits (4: the mantissa of fp8 e4m3), the precision below the
configuration's bfloat16.

This module imports nothing of the program, JAX or the JAX package.
"""
from __future__ import annotations

import torch

from benchlib import model_weights as mw

QUERY_BLOCK = 256


def round_to_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded in place to ``bits`` significant bits, to
    nearest even (``round_to_bits(x, 8)`` equals ``x.bfloat16().float()``
    for finite ``x``)."""
    drop = 24 - bits
    i = x.view(torch.int32)
    i.add_(((1 << (drop - 1)) - 1) + ((i >> drop) & 1))
    i.bitwise_and_(~((1 << drop) - 1))
    return x


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope_tables(T: int, hd: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x: (N, H, T, hd)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, bits):
    """Causal softmax attention, q: (N, Hq, T, hd), k, v: (N, Hq, T, hd),
    in blocks of queries."""
    T, hd = q.shape[2], q.shape[3]
    out = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for lo in range(0, T, QUERY_BLOCK):
        hi = min(T, lo + QUERY_BLOCK)
        s = torch.matmul(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) \
            * hd ** -0.5
        s.masked_fill_(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        if bits:
            round_to_bits(p, bits)
        out[:, :, lo:hi] = torch.matmul(p, v[:, :, :hi])
        del p
    return out


def _layer(x, w: dict, config: dict, cos, sin, bits):
    s = mw.shape_of(config)
    N, T, _ = x.shape
    hq, hkv, hd = s["hq"], s["hkv"], s["hd"]
    eps = config["rms_norm_eps"]
    h = _rms(x, w["norm1.scale"], eps)

    def heads(y, n):
        return y.view(N, T, n, hd).transpose(1, 2)

    q = heads(h @ w["mixer.wq"] + w.get("mixer.bq", 0.0), hq)
    k = heads(h @ w["mixer.wk"] + w.get("mixer.bk", 0.0), hkv)
    v = heads(h @ w["mixer.wv"] + w.get("mixer.bv", 0.0), hkv)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    # query head i reads kv head i // (hq / hkv)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    a = _attention(q, k, v, bits).transpose(1, 2).reshape(N, T, hq * hd)
    del q, k, v
    x = x + a @ w["mixer.wo"]
    h = _rms(x, w["norm2.scale"], eps)
    x = x + (torch.nn.functional.silu(h @ w["ffn.w1"]) * (h @ w["ffn.w3"])) \
        @ w["ffn.w2"]
    if bits:
        round_to_bits(x, bits)
    return x


def logits(config: dict, seed: int, tokens: torch.Tensor, first: int, *,
           bits: int | None = None) -> torch.Tensor:
    """Float32 logits (N, T - first, vocab) at positions ``first`` .. T-1
    of the (N, T) token sequences ``tokens``, on their device, the model's
    weights drawn from ``seed``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = tokens.device
    s = mw.shape_of(config)
    T = tokens.shape[1]
    with torch.no_grad():
        embed = mw.draw(config, seed, "embed", (s["vocab"], s["d"]),
                        "matrix", dev)
        x = embed[tokens.long()].float()
        del embed
        cos, sin = _rope_tables(T, s["hd"], config["rope_theta"], dev)
        for u in range(s["layers"]):
            x = _layer(x, mw.layer(config, seed, u, dev), config, cos, sin,
                       bits)
        scale = mw.draw(config, seed, "final_norm.scale", (s["d"],), "norm",
                        dev)
        h = _rms(x[:, first:], scale, config["rms_norm_eps"])
        del x
        head = mw.draw(config, seed, "lm_head", (s["d"], s["vocab"]),
                       "matrix", dev).float()
        return h @ head
