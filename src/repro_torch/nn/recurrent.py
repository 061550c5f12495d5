"""RG-LRU (Griffin / RecurrentGemma), the recurrent mixer; the port of the
RG-LRU part of ``repro/nn/recurrent.py``.

RG-LRU is a *diagonal* linear recurrence. The reference runs it with
``jax.lax.associative_scan`` and names the Pallas ``lru_scan`` kernel its
TPU fast path; here :func:`rglru_forward` runs it through
``ops.lru_scan``, which follows the tensor's device (``use_kernel=None``):
the CUDA kernel on a card, the plain sequential loop on the CPU. Each
block also exposes the single-step decode update. mLSTM and sLSTM (xLSTM)
wait for their slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn.layers import dense, gelu, normal_, param, weight_dtype

C_RGLRU = 8.0


# ---------------------------------------------------------------- causal conv
class Conv(nn.Module):
    """Depthwise causal convolution kernel ``w`` (width, channels)."""

    def __init__(self, width: int, channels: int, dtype, device,
                 trainable: bool = False):
        super().__init__()
        self.w = param((width, channels), dtype, device, trainable=trainable)


def causal_conv(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); kernel (W, C)."""
    w = p.w.float()
    xf = x.float()
    out = torch.zeros_like(xf)
    S = x.shape[1]
    for k in range(w.shape[0]):
        shifted = F.pad(xf, (0, 0, k, 0))[:, :S]
        out = out + shifted * w[k]
    return out.to(x.dtype)


def causal_conv_step(p: Conv, x_t: torch.Tensor, state: torch.Tensor):
    """x_t: (B, C); state: (B, W-1, C) of prior inputs (most recent last).
    Returns (output (B, C), new state)."""
    w = p.w.float()
    width = w.shape[0]
    hist = torch.cat([state, x_t[:, None].float()], dim=1)
    taps = hist[:, -width:]                                  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", taps, w)
    return out.to(x_t.dtype), hist[:, 1:]


# -------------------------------------------------------------------- RG-LRU
class RGLRU(nn.Module):
    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        wd = weight_dtype(cfg, device, trainable)
        pd = getattr(torch, cfg.param_dtype)
        t = trainable
        self.in_x = param((d, w), wd, device, trainable=t)
        self.in_gate = param((d, w), wd, device, trainable=t)
        # read in float32 by the reference (recurrent.py:26,37): param dtype
        self.conv = Conv(cfg.conv_width, w, pd, device, t)
        # per-channel gate affines + recurrence parameter Lambda
        self.w_ig = param((w,), torch.float32, device, trainable=t)
        self.b_ig = param((w,), torch.float32, device, 0.0, t)
        self.w_rg = param((w,), torch.float32, device, trainable=t)
        self.b_rg = param((w,), torch.float32, device, 0.0, t)
        self.a_param = param((w,), torch.float32, device, 2.0, t)
        self.out = param((w, d), wd, device, trainable=t)


def init_rglru_block(cfg, generator: torch.Generator, device,
                     trainable: bool = False) -> RGLRU:
    p = RGLRU(cfg, device, trainable)
    for t in (p.in_x, p.in_gate, p.conv.w, p.w_ig, p.w_rg, p.out):
        normal_(t.data, generator)
    return p


def _rglru_coeffs(p: RGLRU, u: torch.Tensor):
    """u: (B, S, W) float32 conv output -> per-step (a, b) of the
    recurrence."""
    r = torch.sigmoid(u * p.w_rg + p.b_rg)
    i = torch.sigmoid(u * p.w_ig + p.b_ig)
    log_a = -C_RGLRU * F.softplus(p.a_param) * r
    a = torch.exp(log_a)
    # 1 - a^2 computed stably
    b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) \
        * (i * u)
    return a, b


def rglru_forward(p: RGLRU, x: torch.Tensor, cfg, use_kernel=None,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D). ``use_kernel`` as in
    :mod:`repro_torch.kernels.ops` (None: the kernel on a card)."""
    conv_in = dense(x, p.in_x).float()
    gate = gelu(dense(x, p.in_gate).float())
    u = causal_conv(p.conv, conv_in)
    a, b = _rglru_coeffs(p, u)
    h = ops.lru_scan(a, b, use_kernel=use_kernel)
    out = (h * gate).to(x.dtype)
    y = dense(out, p.out)
    if return_state:
        cw = cfg.conv_width
        # copies, so the cache does not hold the (B, S, W) tensors alive
        state = {"h": h[:, -1].clone(),
                 "conv": conv_in[:, x.shape[1] - (cw - 1):].clone()}
        return y, state
    return y


def init_rglru_cache(cfg, batch: int, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=torch.float32, device=device),
    }


def rglru_decode(p: RGLRU, x: torch.Tensor, cfg, cache: dict):
    """x: (B, 1, D) -> (B, 1, D) with the carried state."""
    xt = x[:, 0]
    u = dense(xt, p.in_x).float()
    gate = gelu(dense(xt, p.in_gate).float())
    u, conv_state = causal_conv_step(p.conv, u, cache["conv"])
    a, b = _rglru_coeffs(p, u.float())
    h = a * cache["h"] + b
    out = dense((h * gate).to(x.dtype), p.out)
    return out[:, None], {"h": h, "conv": conv_state}
