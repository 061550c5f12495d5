"""Gradient compression: int8 quantization with error feedback; the port of
``repro/train/compression.py``.

Each gradient is quantized to int8 with a per-tensor scale, dequantized,
and the quantization error is fed back into the next step's gradient
(error feedback keeps SGD/Adam convergence). In the reference the pair
brackets the data-parallel all-reduce; on one device it runs inline, as
the reference's CPU examples run it. Trees are dicts of tensors keyed by
parameter name; ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""
from __future__ import annotations

import torch


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def quantize(g: torch.Tensor, err: torch.Tensor):
    """-> (q int8, scale f32 scalar, new residual)."""
    gf = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: dict, err_state: dict):
    """Error-feedback quantization of every gradient. Returns (dequantized
    grads, new error state, stats)."""
    outs, new_errs = {}, {}
    for name, g in grads.items():
        q, scale, resid = quantize(g, err_state[name])
        outs[name] = dequantize(q, scale).to(g.dtype)
        new_errs[name] = resid
    raw = sum(g.numel() * g.element_size() for g in grads.values())
    compressed = sum(g.numel() + 4 for g in grads.values())  # int8 + scale
    return outs, new_errs, {"bytes_raw": raw, "bytes_compressed": compressed,
                            "ratio": raw / max(compressed, 1)}
