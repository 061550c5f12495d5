"""Attention: GQA with RoPE / biases / qk-norm / sliding-window / local-block;
the port of ``repro/nn/attention.py``.

Two routes for the prefill, chosen by ``attn_forward``'s ``use_kernel``
(None follows the tensor's device, as in :mod:`repro_torch.kernels.ops`):

* the kernel route — ``ops.flash_attention``, the hand-written CUDA kernel
  that stands for the reference's Pallas ``flash_attention`` (its TPU fast
  path);
* the plain route — the reference's portable path, ported as it is:
  ``_causal_blocked`` (full causal, per q block an online softmax over the
  kv chunks up to it) and ``_windowed_blocked`` (each q block of width W
  attends to its own and the previous block, masked down to W).

``attn_decode`` is a single-token query against a KV cache, on two routes
chosen the same way:

* the kernel route — ``ops.decode_attention``, a hand-written CUDA pass
  over the bf16 cache's attended positions (it stands for no TPU kernel:
  the reference's decode attention is an einsum);
* the plain route — the reference's einsum, its products in float32 from
  inputs in the compute dtype (``preferred_element_type=float32``) over a
  float32 copy of the whole cache, masked to the attended positions
  (``kernels.ref.decode_attention``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.nn.layers import (compute_dtype, dense, normal_, param,
                                   rms_norm, weight_dtype)
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


def window_for(kind: str, cfg):
    if kind == "local":
        return cfg.local_window
    if kind == "swa":
        return cfg.swa_window
    return None  # attn / global: full causal


class Attention(nn.Module):
    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d = cfg.d_model
        wd = weight_dtype(cfg, device, trainable)
        pd = getattr(torch, cfg.param_dtype)
        t = trainable
        self.wq = param((d, cfg.q_dim), wd, device, trainable=t)
        self.wk = param((d, cfg.kv_dim), wd, device, trainable=t)
        self.wv = param((d, cfg.kv_dim), wd, device, trainable=t)
        self.wo = param((cfg.q_dim, d), wd, device, trainable=t)
        if cfg.qkv_bias:
            self.bq = param((cfg.q_dim,), pd, device, 0.0, t)
            self.bk = param((cfg.kv_dim,), pd, device, 0.0, t)
            self.bv = param((cfg.kv_dim,), pd, device, 0.0, t)
        if cfg.qk_norm:
            hd = cfg.resolved_head_dim
            self.q_norm = param((hd,), torch.float32, device, 0.0, t)
            self.k_norm = param((hd,), torch.float32, device, 0.0, t)


def init_attn(cfg, generator: torch.Generator, device,
              trainable: bool = False) -> Attention:
    p = Attention(cfg, device, trainable)
    for t in (p.wq, p.wk, p.wv, p.wo):
        normal_(t.data, generator)
    return p


def _project_qkv(p: Attention, x: torch.Tensor, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(x, p.wq, getattr(p, "bq", None)).reshape(B, S, cfg.n_heads, hd)
    k = dense(x, p.wk, getattr(p, "bk", None)).reshape(B, S, cfg.n_kv_heads,
                                                        hd)
    v = dense(x, p.wv, getattr(p, "bv", None)).reshape(B, S, cfg.n_kv_heads,
                                                        hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if cfg.rope:
        q = apply_rope(q.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta).transpose(1, 2)
    # (B, H, S, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _gqa_shape(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, S, hd) -> (B, Hkv, G, S, hd)."""
    B, Hq, S, hd = q.shape
    return q.reshape(B, n_kv, Hq // n_kv, S, hd)


def _online_merge(m, l, acc, scores, v_chunk):
    """One online-softmax update.
    scores: (B, Hkv, G, Sq, C) f32; v_chunk: (B, Hkv, C, hd)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqc,bhcd->bhgqd", p.to(v_chunk.dtype).float(), v_chunk.float())
    return m_new, l_new, acc_new


def _causal_blocked(q, k, v, cfg):
    """Full causal. q: (B, Hkv, G, S, hd); k, v: (B, Hkv, S, hd). Like the
    reference, it covers S // C whole q blocks of C = min(kv_chunk, S) rows
    and drops a ragged tail (``attn_forward`` refuses that case)."""
    B, Hkv, G, S, hd = q.shape
    C = min(cfg.kv_chunk, S)
    nq = S // C
    scale = hd ** -0.5
    arange = torch.arange(C, device=q.device)
    outs = []
    for i in range(nq):  # causal-optimal: q block i reads kv chunks <= i
        qi = q[:, :, :, i * C:(i + 1) * C].float()            # (B,Hkv,G,C,hd)
        m = torch.full((B, Hkv, G, C), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, C), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, C, hd), dtype=torch.float32,
                          device=q.device)
        pos_q = i * C + arange
        for j in range(i + 1):
            kj = k[:, :, j * C:(j + 1) * C]
            vj = v[:, :, j * C:(j + 1) * C]
            scores = torch.einsum("bhgqd,bhcd->bhgqc", qi, kj.float()) * scale
            mask = (j * C + arange)[None, :] <= pos_q[:, None]
            scores = scores.masked_fill(~mask, NEG_INF)
            m, l, acc = _online_merge(m, l, acc, scores, vj)
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    return torch.cat(outs, dim=3).to(q.dtype)              # (B,Hkv,G,S,hd)


def _windowed_blocked(q, k, v, window: int, cfg):
    """Local / SWA attention: q block i attends kv blocks {i-1, i} (block
    -1 is zeros, masked out). Falls back to :func:`_causal_blocked` when S
    is not a multiple of the window, as the reference does
    (``attention.py:130-131``), which then ignores the window. The
    reference takes every block in one product; the port walks the blocks,
    each one's scores, softmax and product the reference's, so that only
    one block's (W, 2W) float32 scores are live (mixtral's window of 4096
    at S = 8192 would hold two blocks' 12 GiB, twice over)."""
    B, Hkv, G, S, hd = q.shape
    W = min(window, S)
    if S % W != 0:   # the reference's fallback (smoke-test sizes)
        return _causal_blocked(q, k, v, cfg)
    scale = hd ** -0.5
    dev = q.device
    wq = torch.arange(W, device=dev)[:, None]           # in-block q offset
    wk = torch.arange(2 * W, device=dev)[None, :] - W   # kv offset vs block
    out = torch.empty((B, Hkv, G, S, hd), dtype=q.dtype, device=dev)
    zeros = torch.zeros_like(k[:, :, :W])
    for n in range(S // W):
        lo = n * W
        prev = slice(lo - W, lo)
        k2 = torch.cat([zeros if n == 0 else k[:, :, prev],
                        k[:, :, lo:lo + W]], dim=2)         # (B,Hkv,2W,hd)
        v2 = torch.cat([zeros if n == 0 else v[:, :, prev],
                        v[:, :, lo:lo + W]], dim=2)
        scores = torch.einsum("bhgqd,bhkd->bhgqk",
                              q[:, :, :, lo:lo + W].float(),
                              k2.float()) * scale
        pos_q, pos_k = lo + wq, lo + wk
        mask = (pos_k <= pos_q) & (pos_q - pos_k < W) & (pos_k >= 0)
        scores.masked_fill_(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        del scores
        probs = probs.to(v2.dtype)
        out[:, :, :, lo:lo + W] = torch.einsum(
            "bhgqk,bhkd->bhgqd", probs.float(), v2.float()).to(q.dtype)
        del probs
    return out


def _check_causal_chunks(S: int, cfg) -> None:
    """The reference's ``_causal_blocked`` drops the ragged tail block when
    S > kv_chunk and S % kv_chunk != 0, and ``attn_forward``'s reshape then
    raises TypeError (``attention.py:94-123,165``). Raise the same."""
    C = min(cfg.kv_chunk, S)
    if S % C:
        raise TypeError(f"causal attention over S={S} needs S to be a "
                        f"multiple of kv_chunk={cfg.kv_chunk} when longer "
                        "than it (the reference drops the ragged tail)")


def attn_forward(p: Attention, x: torch.Tensor, cfg, kind: str,
                 positions: torch.Tensor, return_kv: bool = False,
                 use_kernel=None):
    """Training / prefill path. x: (B, S, D); positions: (B, S) int."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    B, S = x.shape[:2]
    window = window_for(kind, cfg)
    windowed = window is not None and window < S
    if not windowed or S % window:
        # the causal path, plain or kernel: the reference's fallback drops
        # the window whenever S is not a multiple of it
        _check_causal_chunks(S, cfg)
        window = None
    if ops.wants_kernel(q, use_kernel):
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=window,
                                  use_kernel=True)
    else:
        qg = _gqa_shape(q, cfg.n_kv_heads)
        if windowed:
            out = _windowed_blocked(qg, k, v, window_for(kind, cfg), cfg)
        else:
            out = _causal_blocked(qg, k, v, cfg)
    out = out.reshape(B, cfg.n_heads, S, -1).transpose(1, 2) \
        .reshape(B, S, cfg.q_dim)
    y = dense(out, p.wo)
    if return_kv:
        cdt = compute_dtype(x.device)
        return y, {"k": k.to(cdt), "v": v.to(cdt)}
    return y


def init_kv_cache(cfg, batch: int, capacity: int, device, dtype=None):
    dtype = dtype or compute_dtype(device)
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.n_kv_heads, capacity, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Attention, x: torch.Tensor, cfg, kind: str, cache: dict,
                pos, use_kernel=None):
    """Single-token decode. x: (B, 1, D); cache k/v: (B, Hkv, capacity, hd);
    pos: the step's positions, (B, 1) int32 on x's device, all one
    position (``models.transformer.decode_step``'s, checked against the
    capacity there), or that position as an int. Nothing here reads the
    position on the host, so a CUDA graph of the step replays at every
    position. Writes the new key and value into the cache in place (the
    reference's ``dynamic_update_slice`` makes a new array; the port saves
    that copy of the whole cache per step) and returns it."""
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)        # (B, H, 1, hd)
    ck, cv = cache["k"], cache["v"]
    at = positions[0]                                   # (1,): the position
    ck[:, :, at] = k.to(ck.dtype)
    cv[:, :, at] = v.to(cv.dtype)
    window = window_for(kind, cfg)
    # the kernel route only on a card: tests that stand plain versions in
    # for the prefill's kernels (patching ops.wants_kernel) keep the decode
    # on its plain route on the CPU
    if ops.wants_kernel(q, use_kernel) and ops.on_card(q):
        out = ops.decode_attention(q[:, :, 0], ck, cv, at, window=window,
                                   use_kernel=True)
    else:
        out = ref.decode_attention(q[:, :, 0], ck, cv, at, window=window)
    y = dense(out.reshape(B, 1, cfg.q_dim).to(x.dtype), p.wo)
    return y, {"k": ck, "v": cv}
