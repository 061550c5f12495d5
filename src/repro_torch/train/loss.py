"""Chunked-vocab cross entropy; the port of ``repro/train/loss.py``.

Never materializes the full (B·S, V) logits: tokens are processed in chunks
and each chunk runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so its logits are recomputed in the backward pass and
peak memory stays at one (chunk, V) block. The reference's ``constrain``
mesh hint is left out: on one card ``launch.sharding.constrain`` returns
its input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.layers import (bf16_backward_enabled, bf16_backward_scope,
                                   dense)


def _chunk_loss(lm_head, hc, yc, softcap: float, bwd16: bool):
    # the recompute runs in the backward, outside the caller's scope
    with bf16_backward_scope(bwd16):
        logits = dense(hc, lm_head).float()                  # (chunk, V)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    yc_safe = torch.clamp(yc, min=0)
    ll = torch.gather(logits, 1, yc_safe[:, None].long())[:, 0]
    mask = (yc >= 0).float()
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_cross_entropy(lm_head, hidden, labels, *, chunk: int = 2048,
                          softcap: float = 0.0):
    """hidden: (B, S, D); labels: (B, S) int, -1 = ignore.
    Returns (sum_loss, token_count), float32 scalars."""
    B, S, D = hidden.shape
    T = B * S
    h = hidden.reshape(T, D)
    y = labels.reshape(T)
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=-1)
    n = (T + pad) // chunk
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bwd16 = bf16_backward_enabled()
    for i in range(n):
        hc = h[i * chunk:(i + 1) * chunk]
        yc = y[i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            lc, cc = checkpoint(_chunk_loss, lm_head, hc, yc, softcap, bwd16,
                                use_reentrant=False)
        else:
            lc, cc = _chunk_loss(lm_head, hc, yc, softcap, bwd16)
        loss = loss + lc
        cnt = cnt + cc
    return loss, cnt
