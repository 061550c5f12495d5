"""Core layers: norms, MLPs, embeddings (the port of ``repro/nn/layers.py``).

Numerics policy, the reference's: matrix products take their inputs in the
compute dtype (bfloat16 on a CUDA device, float32 on the CPU) and
accumulate in float32; norms, softmax and gating run in float32. The
parameters live in ``nn.Module``s; the math is plain functions on tensors
that take the module as ``p``.

For serving, weights that reach only :func:`dense` or the embedding
gather are held in the compute dtype (``weight_dtype``). The reference
holds them in float32 and casts them to bfloat16 before every product, so
the result is the same bit for bit; holding them cast saves the cast's
traffic on every step. Everything the reference reads in float32 (norm
scales, gate vectors, the convolution) stays float32. A trainable model
(``trainable=True``) keeps every parameter in ``cfg.param_dtype`` (the
float32 master weights the optimizer updates) with ``requires_grad``;
:func:`dense` casts to the compute dtype on every call, as the reference
does.

:func:`bf16_backward_scope` is the reference's performance knob: within
it, :func:`dense` on bf16 compute takes an autograd Function whose
activation gradient is bf16 while the weight gradient is accumulated in
float32.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import stands_for


def compute_dtype(device) -> torch.dtype:
    """bfloat16 on a CUDA device, float32 elsewhere: the reference's rule of
    bf16 on the accelerator and f32 when executing on the CPU backend (a
    meta device follows the device it stands for, ``device.meta_as``)."""
    return torch.bfloat16 if stands_for(device).type == "cuda" \
        else torch.float32


def weight_dtype(cfg, device, trainable: bool = False) -> torch.dtype:
    """Dtype of the weights that only :func:`dense` or the embedding gather
    read: for serving the compute dtype on a CUDA device; else (the CPU,
    where both are float32, or a trainable model) ``cfg.param_dtype``."""
    if stands_for(device).type == "cuda" and not trainable:
        return compute_dtype(device)
    return getattr(torch, cfg.param_dtype)


def normal_(t: torch.Tensor, generator: torch.Generator,
            std: float = 0.02) -> torch.Tensor:
    """Fill ``t`` in place from N(0, std^2), drawn in float32 (the
    reference's ``Init``) and rounded to ``t``'s dtype."""
    if t.dtype == torch.float32:
        return t.normal_(0.0, std, generator=generator)
    src = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return t.copy_(src.normal_(0.0, std, generator=generator))


def param(shape, dtype, device, fill=None,
          trainable: bool = False) -> nn.Parameter:
    """A parameter, uninitialised unless ``fill`` is given; frozen (serving
    needs no gradient) unless ``trainable``."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=trainable)


def strict_matmul() -> None:
    """Hold cuBLAS to the reference's numerics. float32 products run in
    full float32, not TF32 (``allow_tf32``). bf16 products accumulate in
    float32 and round once: with ``allow_bf16_reduced_precision_reduction``
    True, cuBLAS may reduce split-k partial sums in bf16, which the
    reference's ``preferred_element_type=float32`` never does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


_BWD_BF16 = contextvars.ContextVar("repro_torch_bwd_bf16", default=False)


@contextlib.contextmanager
def bf16_backward_scope(enabled: bool = True):
    """Within this scope :func:`dense` on bf16 compute (a CUDA device)
    differentiates through :class:`DenseBf16Bwd`: activation gradients in
    bf16, weight gradients accumulated in float32. On float32 compute (the
    CPU) it changes nothing, as the reference's scope does nothing where
    its compute dtype is float32. Code that recomputes a forward later
    (``torch.utils.checkpoint``) must re-enter the scope with
    :func:`bf16_backward_enabled`'s value."""
    tok = _BWD_BF16.set(bool(enabled))
    try:
        yield
    finally:
        _BWD_BF16.reset(tok)


def bf16_backward_enabled() -> bool:
    return _BWD_BF16.get()


class DenseBf16Bwd(torch.autograd.Function):
    """x @ w in bf16 with float32 accumulation (a bf16 result), whose
    backward gives dx as a bf16 product and dw accumulated in float32
    (the reference's ``_dense_bf16bwd``, ``nn/layers.py:67-98``): the bf16
    products are exact in float32, so dw is their float32 sum."""

    @staticmethod
    def forward(ctx, x, w):
        xc, wc = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xc, wc)
        ctx.dtypes = (x.dtype, w.dtype)
        return torch.matmul(xc, wc)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        x_dt, w_dt = ctx.dtypes
        gc = g.to(torch.bfloat16)
        dx = torch.matmul(gc, wc.t())
        dw = torch.matmul(xc.reshape(-1, xc.shape[-1]).t().float(),
                          gc.reshape(-1, gc.shape[-1]).float())
        return dx.to(x_dt), dw.to(w_dt)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          ) -> torch.Tensor:
    """x @ w with inputs in the compute dtype, float32 accumulation and a
    result in the compute dtype. On a card this relies on
    :func:`strict_matmul` having been called. The reference's
    ``accum`` knob (the dtype of a tensor-parallel all-reduce) has no
    counterpart on one device."""
    dt = compute_dtype(x.device)
    if _BWD_BF16.get() and dt == torch.bfloat16:
        y = DenseBf16Bwd.apply(x, w)
    else:
        y = torch.matmul(x.to(dt), w.to(dt))
    if b is not None:
        y = (y.float() + b.float()).to(dt)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """RMS norm (``scale``, zero-initialised: the multiplier is 1 + scale)
    or layer norm (``scale`` ones, ``bias`` zeros)."""

    def __init__(self, d: int, kind: str, device, trainable: bool = False):
        super().__init__()
        self.kind = kind
        if kind == "rms":
            self.scale = param((d,), torch.float32, device, 0.0, trainable)
        else:
            self.scale = param((d,), torch.float32, device, 1.0, trainable)
            self.bias = param((d,), torch.float32, device, 0.0, trainable)


def init_norm(d: int, kind: str, device, trainable: bool = False) -> Norm:
    return Norm(d, kind, device, trainable)


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p.scale)
    return layer_norm(x, p.scale, p.bias)


class MLP(nn.Module):
    """Gated (swiglu/geglu: ``w1``, ``w3``, ``w2``) or plain (``w1``,
    ``w2``, biases under ``mlp_bias``) feed-forward."""

    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        wd = weight_dtype(cfg, device, trainable)
        self.w1 = param((d, ff), wd, device, trainable=trainable)
        if cfg.ffn in ("swiglu", "geglu"):
            self.w3 = param((d, ff), wd, device, trainable=trainable)
        self.w2 = param((ff, d), wd, device, trainable=trainable)
        if cfg.ffn not in ("swiglu", "geglu") and cfg.mlp_bias:
            pd = getattr(torch, cfg.param_dtype)
            self.b1 = param((ff,), pd, device, 0.0, trainable)
            self.b2 = param((d,), pd, device, 0.0, trainable)


def init_mlp(cfg, generator: torch.Generator, device,
             trainable: bool = False) -> MLP:
    p = MLP(cfg, device, trainable)
    for name in ("w1", "w3", "w2"):
        if hasattr(p, name):
            normal_(getattr(p, name).data, generator)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form: ``jax.nn.gelu``'s default (``approximate=True``),
    which every reference call site uses; torch's default is exact."""
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    act = F.silu if cfg.ffn == "swiglu" else gelu
    if cfg.ffn in ("swiglu", "geglu"):
        h = act(dense(x, p.w1)) * dense(x, p.w3)
        return dense(h, p.w2)
    h = act(dense(x, p.w1, getattr(p, "b1", None)))
    return dense(h, p.w2, getattr(p, "b2", None))


def sinusoidal_positions(seq_len: int, d_model: int,
                         offset: int = 0) -> torch.Tensor:
    """The static (seq_len, d_model) float32 table of positions
    ``offset .. offset + seq_len - 1``: sines in the even columns, cosines
    in the odd, computed in float64 by NumPy and rounded once, as the
    reference's ``sinusoidal_positions`` (which the reference's model never
    calls either; it uses the dynamic form below)."""
    pos = np.arange(seq_len)[:, None] + offset
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10_000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out)


def sinusoidal_positions_dynamic(positions: torch.Tensor,
                                 d_model: int) -> torch.Tensor:
    """Positions given as a tensor (decode). positions: (S,) int."""
    pos = positions.float()[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d_model)
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(positions.shape[0], d_model)


def embed_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d_model) rounded to the compute dtype, as the reference's
    ``jnp.asarray(math.sqrt(d_model), dt)``: 50.5 for 2560 in bfloat16."""
    return torch.tensor(math.sqrt(d_model), dtype=dtype)
