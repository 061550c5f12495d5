"""Multi-head latent attention (DeepSeek-V2), the mixer kind ``mla``.

The port's own mixer; the reference has none. With ``cfg.kv_lora_rank``
R, ``qk_nope_head_dim`` N, ``qk_rope_head_dim`` Rp and ``v_head_dim`` V
(DeepSeek-V2's published modelling code, without a q LoRA):

  q = x W_q                   (H heads of N + Rp: q_nope, then q_pe)
  [c, k_pe] = x W_kva         (R + Rp), then c = RMSNorm(c)
  [k_nope, v] = c W_kvb       (H heads of N + V)
  q_pe, k_pe rotated          (pairs (2i, 2i+1) at frequency i; k_pe is
                               one head that every query head reads)
  scores = (q_nope . k_nope + q_pe . k_pe) * softmax_scale(cfg)
  out = softmax(causal scores) v, then W_o.

The decode cache holds, per position, the normed latent c and the rotated
k_pe: R + Rp numbers a layer, ``{"latent": (B, capacity, R + Rp)}`` in the
compute dtype.

Two paths, as the published inference code has them:

* the prefill decompresses the latent into per-head keys and values and
  attends with ``_attend``: on a card the ``wgmma`` flash-attention kernel
  (``kernels/flash_attention.py``) with q and k zero-padded from N + Rp
  and v from V to the kernel's head dim of 256 (zeros add nothing to a
  dot product, and the padded output columns are dropped), q scaled so
  that the kernel's 256^-1/2 gives ``softmax_scale``; elsewhere a plain
  float32 causal softmax in blocks of queries. It runs over sequences in
  groups of at most ``PREFILL_TOKENS`` tokens, so the decompressed keys
  and values of only one group are live.
* a decode step attends in the absorbed form over the latent cache:
  q_lat = q_nope W_uk^T (W_uk, W_uv: the key and value halves of W_kvb),
  scores = [q_lat, q_pe] . [c, k_pe] over the positions up to the step,
  out = (P c) W_uv. Its products read the cache in the compute dtype and
  accumulate in float32; the scores come out in float32 for the softmax
  (a GEMM with a float32 result), every other product rounded once to
  the compute dtype. No copy of the cache is made.

The rotations are one complex table per device, computed in float64 and
rounded once, for positions up to a power of two past the longest seen;
a decode step reads its position's row as a view.

Each call is a ``Model.mla`` span (``repro_torch.trace``) with attributes
``phase`` (prefill or decode) and ``positions`` (attended positions a
query at most).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.configs.base import yarn_mscale
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
from repro_torch.nn.layers import (compute_dtype, dense, param, rms_norm,
                                   weight_dtype)
from repro_torch.nn.rope import (apply_rope_pairs, rope_rotations,
                                 yarn_inv_freq)

NEG_INF = -1e30
PREFILL_TOKENS = 65_536     # tokens of one prefill group of sequences
QUERY_BLOCK = 256           # queries a block on the plain route


class MLA(nn.Module):
    """``wq`` (D, H (N + Rp)), ``wkva`` (D, R + Rp), ``kv_norm`` (R,)
    float32 (the latent RMSNorm's scale: the multiplier is 1 + scale),
    ``wkvb`` (R, H (N + V)), ``wo`` (H V, D)."""

    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        nope, rope, v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
        wd = weight_dtype(cfg, device, trainable)
        t = trainable
        self.wq = param((d, h * (nope + rope)), wd, device, trainable=t)
        self.wkva = param((d, r + rope), wd, device, trainable=t)
        self.kv_norm = param((r,), torch.float32, device, 0.0, t)
        self.wkvb = param((r, h * (nope + v)), wd, device, trainable=t)
        self.wo = param((h * v, d), wd, device, trainable=t)


def softmax_scale(cfg) -> float:
    """(N + Rp)^-1/2, times YaRN's mscale(factor, mscale_all_dim)^2."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        m = yarn_mscale(y.factor, y.mscale_all_dim)
        scale *= m * m
    return scale


@functools.lru_cache(maxsize=16)
def _rotations_on(dim: int, theta: float, yarn, device: str,
                  n: int) -> torch.Tensor:
    # made once per device and length: a table built on the card from
    # host data would be a blocking copy on every step
    factor = 1.0
    if yarn is not None:
        factor = yarn_mscale(yarn.factor, yarn.mscale) \
            / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return rope_rotations(yarn_inv_freq(dim, theta, yarn), n, device,
                          factor)


def rope_tables(cfg, positions, device=None):
    """The complex rotations of the rotated part, YaRN's frequencies and
    table scale applied: (..., S, Rp / 2) for a tensor of ``positions``
    (..., S), each under S (a prefill's or a forward's, which the table's
    length is taken from without reading them), or (Rp / 2,) for one int
    position (a view of the table, no launch) on ``device``."""
    top = int(positions) if isinstance(positions, int) else \
        positions.shape[-1] - 1
    if not isinstance(positions, int):
        device = positions.device
    n = 1 << max(12, top.bit_length())          # the table's length
    table = _rotations_on(cfg.qk_rope_head_dim, float(cfg.rope_theta),
                          cfg.rope_scaling, str(device), n)
    if isinstance(positions, int):
        return table[positions]
    return table[positions.long()]


def _project(p: MLA, x: torch.Tensor, cfg, rot: torch.Tensor):
    """x (B, S, D) and its positions' rotations ``rot`` (broadcastable to
    (B, S, Rp / 2)) -> q_nope (B, S, H, N), rotated q_pe (B, S, H, Rp),
    the normed latent c (B, S, R) and the rotated k_pe (B, S, Rp), each in
    the compute dtype."""
    B, S, _ = x.shape
    nope, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = dense(x, p.wq).view(B, S, cfg.n_heads, -1)
    kva = dense(x, p.wkva)
    c = rms_norm(kva[..., :r], p.kv_norm)
    q_pe = apply_rope_pairs(q[..., nope:], rot.unsqueeze(-2))
    k_pe = apply_rope_pairs(kva[..., r:], rot)
    return q[..., :nope], q_pe, c, k_pe


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, causal: bool = True, use_kernel=None):
    """Softmax attention of q, k (B, H, S, dqk) and v (B, H, S, dv), the
    scores times ``scale``; (B, H, S, dv) in q's dtype."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if ops.wants_kernel(q, use_kernel):
        hd = min(h for h in WGMMA_HEAD_DIMS if h >= max(dqk, dv))
        qp = F.pad((q.float() * (scale * hd ** 0.5)).to(q.dtype),
                   (0, hd - dqk))
        out = ops.flash_attention(qp, F.pad(k, (0, hd - dqk)),
                                  F.pad(v, (0, hd - dv)), causal=causal,
                                  use_kernel=True)
        return out[..., :dv]
    S = q.shape[2]
    out = torch.empty(q.shape[:-1] + (dv,), dtype=q.dtype, device=q.device)
    pos = torch.arange(S, device=q.device)
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        kv_hi = hi if causal else S
        s = torch.matmul(q[:, :, lo:hi].float(),
                         k[:, :, :kv_hi].float().transpose(-1, -2)) * scale
        if causal:
            s.masked_fill_(pos[None, :kv_hi] > pos[lo:hi, None], NEG_INF)
        probs = torch.softmax(s, dim=-1)
        out[:, :, lo:hi] = torch.matmul(probs, v[:, :, :kv_hi].float()) \
            .to(q.dtype)
    return out


def _scores(q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """q (B, H, R + Rp) against keys (B, T, R + Rp), both in the cache's
    dtype: (B, H, T) in float32, the products accumulated and kept in
    float32 (on a card a bf16 GEMM with a float32 result)."""
    if q.is_cuda and q.dtype != torch.float32:
        return torch.bmm(q, keys.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(q.float(), keys.float().transpose(1, 2))


def mla_forward(p: MLA, x: torch.Tensor, cfg, positions: torch.Tensor,
                capacity=None, use_kernel=None):
    """Prefill / training path: x (B, S, D), positions (B, S) -> y (B, S,
    D), and with ``capacity`` also the decode cache at the prompt's end,
    padded to ``capacity`` positions."""
    B, S, _ = x.shape
    h, nope, v_dim = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = softmax_scale(cfg)
    y = torch.empty_like(x)
    cache = None
    if capacity is not None:
        cache = {"latent": torch.zeros(
            (B, capacity, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            dtype=compute_dtype(x.device), device=x.device)}
    group = max(1, PREFILL_TOKENS // S)
    with trace.span("Model.mla", phase="prefill", positions=S):
        for lo in range(0, B, group):
            hi = min(B, lo + group)
            q_nope, q_pe, c, k_pe = _project(
                p, x[lo:hi], cfg, rope_tables(cfg, positions[lo:hi]))
            kv = dense(c, p.wkvb).view(hi - lo, S, h, nope + v_dim)
            q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
            k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(
                -1, -1, h, -1)], dim=-1).transpose(1, 2)
            v = kv[..., nope:].transpose(1, 2)
            del kv
            out = _attend(q.contiguous(), k.contiguous(), v.contiguous(),
                          scale, use_kernel=use_kernel)
            del q, k, v
            y[lo:hi] = dense(out.transpose(1, 2).reshape(hi - lo, S,
                                                         h * v_dim), p.wo)
            if cache is not None:
                cache["latent"][lo:hi, :S] = torch.cat([c, k_pe], dim=-1)
    return y if capacity is None else (y, cache)


def init_latent_cache(cfg, batch: int, capacity: int, device, dtype=None):
    dtype = dtype or compute_dtype(device)
    return {"latent": torch.zeros(
        (batch, capacity, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        dtype=dtype, device=device)}


def mla_decode(p: MLA, x: torch.Tensor, cfg, cache: dict, pos: int):
    """One token x (B, 1, D) at position ``pos`` against the latent cache
    (written in place at ``pos``); returns (y (B, 1, D), cache)."""
    B = x.shape[0]
    h, nope, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    with trace.span("Model.mla", phase="decode", positions=pos + 1):
        q_nope, q_pe, c, k_pe = _project(p, x, cfg,
                                         rope_tables(cfg, pos, x.device))
        lat = cache["latent"]
        lat[:, pos] = torch.cat([c, k_pe], dim=-1)[:, 0].to(lat.dtype)
        wkvb = p.wkvb.view(r, h, -1)
        dt = lat.dtype
        # q_lat[b, h] = W_uk[h] q_nope[b, h]: (H, B, N) @ (H, N, R)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1).to(dt),
                          wkvb[..., :nope].permute(1, 2, 0).to(dt))
        qf = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0].to(dt)], dim=-1)
        keys = lat[:, :pos + 1]                             # (B, T, R + Rp)
        scores = _scores(qf, keys) * softmax_scale(cfg)
        probs = torch.softmax(scores, dim=-1)               # (B, H, T)
        o_lat = torch.bmm(probs.to(dt), keys[..., :r])      # (B, H, R)
        # out[b, h] = o_lat[b, h] W_uv[h]: (H, B, R) @ (H, R, V)
        out = torch.bmm(o_lat.transpose(0, 1),
                        wkvb[..., nope:].transpose(0, 1).to(dt))
        y = dense(out.transpose(0, 1).reshape(B, 1, -1).to(x.dtype), p.wo)
    return y, cache
