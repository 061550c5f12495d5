"""Recurrent mixers: RG-LRU (Griffin / RecurrentGemma), mLSTM and sLSTM
(xLSTM); the port of ``repro/nn/recurrent.py``.

RG-LRU is a *diagonal* linear recurrence. The reference runs it with
``jax.lax.associative_scan`` and names the Pallas ``lru_scan`` kernel its
TPU fast path; here :func:`rglru_forward` runs it through
``ops.lru_scan``, which follows the tensor's device (``use_kernel=None``):
the CUDA kernel on a card, the plain sequential loop on the CPU.

mLSTM (matrix memory) and sLSTM (scalar memory with recurrent gate
connections) use stabilised exponential gating. The reference computes
them with ``jax.lax.scan`` and einsums, outside any Pallas kernel, and so
does the port, with a Python loop over time (:func:`_scan`) and tensor
code: they hold no kernel. The mLSTM keeps the reference's three routes:
the chunkwise-parallel form (``mlstm_impl="chunkwise"``), the scan with a
checkpoint per chunk (``mlstm_chunk`` set) and the plain scan. Their
recurrence runs in float32, the dtype of the mixer's float32 biases
(``b_if``, ``b_gates``): the reference's ``astype(float32)`` points. A
copy of a mixer cast with ``.double()`` computes the same function with
that arithmetic in float64, while its products through :func:`dense` stay
in the compute dtype (the weights round back exactly) and the prefill's
convolution stays float32 before its rounding to the input's dtype.

Every block also exposes the single-step decode update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import hlo
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
    Returns (output (B, C), new state). As the reference's, it weights
    x[t - k] by w[W - 1 - k], where :func:`causal_conv` weights it by
    w[k]: the decode reverses the prefill's kernel."""
    w = p.w.float()
    width = w.shape[0]
    if state.shape[1] != width - 1:
        # a prompt shorter than width - 1 leaves a short state; the
        # reference's einsum raises ValueError on it too
        raise ValueError(f"conv state holds {state.shape[1]} positions, "
                         f"the kernel of width {width} needs {width - 1}")
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


# ------------------------------------------------------- xLSTM: shared parts
def _scan(step, carry: tuple, xs: tuple, tc: int = 0):
    """``jax.lax.scan`` of ``step(carry, x_t) -> (carry, y_t)`` over the
    leading (time) axis of the tensors ``xs``: (final carry, the y_t
    stacked). With grad enabled and ``tc`` steps a chunk (``tc`` dividing
    S, S > tc: the reference's condition), each chunk runs under
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
    chunk: the backward keeps the chunks' carries and recomputes their
    steps, where the plain scan keeps every step's."""
    n = len(carry)

    def chunk(*args):
        c, xc = tuple(args[:n]), args[n:]
        # a plain loop over time; the dry-run's counter runs two steps and
        # counts the second for the rest (analysis/hlo.py)
        c, ys = hlo.unrolled(xc[0].shape[0], lambda t, c: step(
            c, tuple(x[t] for x in xc)), c, stack=True)
        return (*c, ys)

    S = xs[0].shape[0]
    if tc and S % tc == 0 and S > tc and torch.is_grad_enabled():
        ys = []
        for lo in range(0, S, tc):
            *carry, y = checkpoint(chunk, *carry,
                                   *(x[lo:lo + tc] for x in xs),
                                   use_reentrant=False)
            ys.append(y)
        return tuple(carry), torch.cat(ys)
    *carry, y = chunk(*carry, *xs)
    return tuple(carry), y


def _gates(i_pre, log_f, m):
    """The stabilised exponential gates of both cells: the new stabiliser
    m_new = max(log f + m, i~), the input gate exp(i~ - m_new) and the
    forget gate exp(log f + m - m_new)."""
    m_new = torch.maximum(log_f + m, i_pre)
    return m_new, torch.exp(i_pre - m_new), torch.exp(log_f + m - m_new)


def _headwise_rms(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMS norm of each head's slice of the last axis, times 1 + scale."""
    xh = x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)
    var = (xh * xh).mean(dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + eps)
    return xh.reshape(x.shape) * (1.0 + scale)


# --------------------------------------------------------------------- mLSTM
def _mlstm_dims(cfg) -> tuple[int, int, int]:
    """(dp, heads, head dim): the up-projected width and its heads."""
    dp = int(cfg.mlstm_proj_factor * cfg.d_model)
    return dp, cfg.n_heads, dp // cfg.n_heads


class MLSTM(nn.Module):
    """mLSTM weights. ``up`` (d, 2 dp) and ``down`` (dp, d) reach only
    :func:`dense` (``weight_dtype``); the convolution ``conv.w`` (width,
    dp), the per-head block-diagonal ``wq``, ``wk``, ``wv`` (h, hd, hd) and
    the gate projection ``w_if`` (dp, 2 h) are read in float32 by the
    reference (``param_dtype``); ``b_if`` (input gates 0, forget gates 3)
    and ``head_norm`` are float32."""

    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d = cfg.d_model
        dp, h, hd = _mlstm_dims(cfg)
        wd = weight_dtype(cfg, device, trainable)
        pd = getattr(torch, cfg.param_dtype)
        t = trainable
        self.up = param((d, 2 * dp), wd, device, trainable=t)
        self.conv = Conv(cfg.conv_width, dp, pd, device, t)
        self.wq = param((h, hd, hd), pd, device, trainable=t)
        self.wk = param((h, hd, hd), pd, device, trainable=t)
        self.wv = param((h, hd, hd), pd, device, trainable=t)
        self.w_if = param((dp, 2 * h), pd, device, trainable=t)
        self.b_if = param((2 * h,), torch.float32, device, 0.0, t)
        self.b_if.data[h:] = 3.0
        self.head_norm = param((dp,), torch.float32, device, 0.0, t)
        self.down = param((dp, d), wd, device, trainable=t)


def _qkvif(p: MLSTM, xh: torch.Tensor, xm: torch.Tensor):
    """q, k (scaled by hd^-1/2), v (..., h, hd) and the gates' pre-
    activations i~, f~ (..., h) from the convolved ``xh`` (..., h, hd) and
    the up-projection ``xm`` (..., dp)."""
    acc = p.b_if.dtype
    h, hd = xh.shape[-2:]
    q = torch.einsum("...hd,hde->...he", xh, p.wq.to(acc))
    k = torch.einsum("...hd,hde->...he", xh, p.wk.to(acc)) * hd ** -0.5
    v = torch.einsum("...hd,hde->...he",
                     xm.reshape(*xm.shape[:-1], h, hd).to(acc), p.wv.to(acc))
    gates = xm.to(acc) @ p.w_if.to(acc) + p.b_if
    return q, k, v, gates[..., :h], gates[..., h:]


def _mlstm_qkvif(p: MLSTM, xm: torch.Tensor, cfg):
    """The prefill's q, k, v, i~, f~ from xm (B, S, dp): the convolution
    runs on xm and rounds to its dtype (bf16 on a card) before the
    float32 silu."""
    B, S, dp = xm.shape
    h = cfg.n_heads
    xh = F.silu(causal_conv(p.conv, xm).to(p.b_if.dtype))
    return _qkvif(p, xh.reshape(B, S, h, dp // h), xm)


def _mlstm_cell_step(carry, inp):
    """One step of the stabilised recurrence. carry: C (B, H, hd, hd), n
    (B, H, hd), m (B, H); inp: q, k, v (B, H, hd), i~, f~ (B, H). Returns
    the new carry and h (B, H, hd). ``C`` is updated as f C + (i v) k^T
    (the reference's f C + i (v k^T), one rounding apart) in one pass."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    m_new, i, f = _gates(i_pre, F.logsigmoid(f_pre), m)
    C_new = torch.addcmul(f[..., None, None] * C,
                          (i[..., None] * v)[..., :, None], k[..., None, :])
    n_new = f[..., None] * n + i[..., None] * k
    h_num = (C_new @ q[..., None])[..., 0]
    h_den = torch.maximum((n_new * q).sum(dim=-1).abs(), torch.exp(-m_new))
    return (C_new, n_new, m_new), h_num / h_den[..., None]


def _mlstm_chunk(Cin, nin, m_in, qL, kL, vL, iL, lfL):
    """One chunk of L steps of the chunkwise-parallel form: the outputs
    from (L, L) decay-masked products, then the carry at the chunk's end.
    Cin (B, H, hd, hd), nin (B, H, hd), m_in (B, H); qL, kL, vL (B, H, L,
    hd); iL and lfL = log sigmoid(f~) (B, H, L). Returns (C, n, m, h (B,
    H, L, hd))."""
    L = qL.shape[-2]
    b = torch.cumsum(lfL, dim=-1)                            # (B, H, L)
    D = b[..., :, None] - b[..., None, :] + iL[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=D.device).tril()
    D = torch.where(tri, D, torch.tensor(-1e30, dtype=D.dtype,
                                         device=D.device))
    m_t = torch.maximum(D.amax(dim=-1), b + m_in[..., None])
    P = torch.exp(D - m_t[..., None]) * (qL @ kL.transpose(-1, -2))
    inter = torch.exp(b + m_in[..., None] - m_t)
    h_num = P @ vL + inter[..., None] * (qL @ Cin.transpose(-1, -2))
    den = P.sum(dim=-1) + inter * (qL @ nin[..., None])[..., 0]
    h = h_num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the carry at the chunk's end, with the sequential form's stabiliser
    bL, m_out = b[..., -1], m_t[..., -1]
    wgt = torch.exp(bL[..., None] - b + iL - m_out[..., None])   # (B, H, L)
    decay_in = torch.exp(bL + m_in - m_out)
    # the reference's einsum "bhs,bhsv,bhsk->bhvk" as (wgt v)^T k: never a
    # (B, H, L, hd, hd) tensor
    C_out = (wgt[..., None] * vL).transpose(-1, -2) @ kL \
        + decay_in[..., None, None] * Cin
    n_out = (wgt[..., None] * kL).sum(dim=-2) + decay_in[..., None] * nin
    return C_out, n_out, m_out, h


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, L: int):
    """Chunkwise-parallel stabilised mLSTM, an exact reformulation of the
    sequential recurrence: q, k, v (B, S, H, hd) (k scaled by hd^-1/2),
    i~, f~ (B, S, H); S a multiple of L. Only the chunk-boundary (C, n, m)
    carries cross chunks; with grad enabled each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
    Returns (h (B, S, H, hd), (C, n, m))."""
    B, S, H, hd = q.shape
    nch = S // L

    def chunks(t):                  # (B, S, H, ...) -> (nch, B, H, L, ...)
        t = t.reshape(B, nch, L, H, *t.shape[3:]).transpose(2, 3)
        return t.transpose(0, 1)

    xs = [chunks(t) for t in (q, k, v, i_pre, F.logsigmoid(f_pre))]
    carry = (q.new_zeros((B, H, hd, hd)), q.new_zeros((B, H, hd)),
             q.new_zeros((B, H)))
    hs = []
    for c in range(nch):
        args = (*carry, *(x[c] for x in xs))
        if torch.is_grad_enabled():
            *carry, h = checkpoint(_mlstm_chunk, *args, use_reentrant=False)
        else:
            *carry, h = _mlstm_chunk(*args)
        hs.append(h)
    hs = torch.stack(hs, dim=1).transpose(2, 3)      # (B, nch, L, H, hd)
    return hs.reshape(B, S, H, hd), tuple(carry)


def _mlstm_out(p: MLSTM, hs, og, n_heads: int, dtype):
    """The mixer's output from the cell outputs ``hs`` (..., dp): head-wise
    norm, the output gate silu(og) and the down-projection."""
    hs = _headwise_rms(hs, p.head_norm, n_heads)
    return dense((hs * F.silu(og.to(hs.dtype))).to(dtype), p.down)


def mlstm_forward(p: MLSTM, x: torch.Tensor, cfg,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D); with ``return_state`` also the decode
    cache at the prompt's end. The route is the reference's: chunkwise when
    ``mlstm_impl == "chunkwise"`` and ``mlstm_chunk`` divides S, else the
    scan (with a checkpoint per chunk under the conditions of
    :func:`_scan`)."""
    B, S, _ = x.shape
    dp, h, hd = _mlstm_dims(cfg)
    z = dense(x, p.up)
    xm, og = z[..., :dp], z[..., dp:]
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, xm, cfg)
    tc = cfg.mlstm_chunk
    if cfg.mlstm_impl == "chunkwise" and tc and S % tc == 0:
        hs, (C, n, m) = _mlstm_chunkwise(q, k, v, i_pre, f_pre, tc)
    else:
        carry = (q.new_zeros((B, h, hd, hd)), q.new_zeros((B, h, hd)),
                 q.new_zeros((B, h)))
        (C, n, m), hs = _scan(_mlstm_cell_step, carry,
                              tuple(t.transpose(0, 1) for t in
                                    (q, k, v, i_pre, f_pre)), tc)
        hs = hs.transpose(0, 1)
    y = _mlstm_out(p, hs.reshape(B, S, dp), og, h, x.dtype)
    if return_state:
        # a copy, so the cache does not hold z alive; a prompt shorter
        # than conv_width - 1 gives a short state, as the reference's
        cw = cfg.conv_width
        conv = xm[:, S - (cw - 1):].to(torch.float32, copy=True)
        return y, {"C": C, "n": n, "m": m, "conv": conv}
    return y


def init_mlstm_cache(cfg, batch: int, device) -> dict:
    dp, h, hd = _mlstm_dims(cfg)

    def zeros(*shape):
        return torch.zeros((batch, *shape), dtype=torch.float32,
                           device=device)
    return {"C": zeros(h, hd, hd), "n": zeros(h, hd), "m": zeros(h),
            "conv": zeros(cfg.conv_width - 1, dp)}


def mlstm_decode(p: MLSTM, x: torch.Tensor, cfg, cache: dict):
    """x: (B, 1, D) -> (B, 1, D) with the carried state. The convolution
    runs on xm cast to float32 and is not rounded, unlike the prefill's
    (the reference's two behaviours)."""
    B = x.shape[0]
    dp, h, hd = _mlstm_dims(cfg)
    z = dense(x[:, 0], p.up)
    xm, og = z[..., :dp], z[..., dp:]
    conv_out, conv_state = causal_conv_step(p.conv, xm.float(),
                                            cache["conv"])
    xh = F.silu(conv_out.to(p.b_if.dtype)).reshape(B, h, hd)
    (C, n, m), hvec = _mlstm_cell_step(
        (cache["C"], cache["n"], cache["m"]), _qkvif(p, xh, xm))
    y = _mlstm_out(p, hvec.reshape(B, dp), og, h, x.dtype)
    return y[:, None], {"C": C, "n": n, "m": m, "conv": conv_state}


# --------------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    """sLSTM weights. The gate input projection ``w_gates`` (d, 4 d: the
    z, i, f, o pre-activations, each (head, hd)) and the per-head
    recurrent ``r_gates`` (h, hd, 4 hd: z, i, f, o within each head) are
    read in float32 by the reference (``param_dtype``); ``b_gates`` and
    ``head_norm`` are float32; the gated feed-forward ``up1``, ``up2`` (d,
    dff) and ``down`` (dff, d) reach only :func:`dense`."""

    def __init__(self, cfg, device, trainable: bool = False):
        super().__init__()
        d = cfg.d_model
        h = cfg.n_heads
        hd = d // h
        dff = int(cfg.slstm_proj_factor * d)
        wd = weight_dtype(cfg, device, trainable)
        pd = getattr(torch, cfg.param_dtype)
        t = trainable
        self.w_gates = param((d, 4 * d), pd, device, trainable=t)
        self.r_gates = param((h, hd, 4 * hd), pd, device, trainable=t)
        self.b_gates = param((4 * d,), torch.float32, device, 0.0, t)
        self.head_norm = param((d,), torch.float32, device, 0.0, t)
        self.up1 = param((d, dff), wd, device, trainable=t)
        self.up2 = param((d, dff), wd, device, trainable=t)
        self.down = param((dff, d), wd, device, trainable=t)


def _slstm_step(p_r: torch.Tensor, carry, wx_t: torch.Tensor):
    """carry: (c, n, m, h_prev), each (B, H, hd); wx_t: (B, H, 4 hd), the
    input's pre-activations of z, i, f, o. Returns the new carry and h."""
    c, n, m, h_prev = carry
    pre = wx_t + torch.einsum("bhd,hde->bhe", h_prev, p_r)
    z_pre, i_pre, f_pre, o_pre = pre.split(c.shape[-1], dim=-1)
    m_new, i, f = _gates(i_pre, F.logsigmoid(f_pre), m)
    c_new = f * c + i * torch.tanh(z_pre)
    n_new = f * n + i
    h = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h), h


def _slstm_wx(p: SLSTM, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., d) -> (..., H, 4 hd): the input's gate pre-activations, from
    w_gates' (gate, head, hd) columns regrouped by head."""
    acc = p.b_gates.dtype
    wx = x.to(acc) @ p.w_gates.to(acc) + p.b_gates
    wx = wx.reshape(*x.shape[:-1], 4, n_heads, -1).transpose(-2, -3)
    return wx.reshape(*x.shape[:-1], n_heads, -1)


def _slstm_out(p: SLSTM, hs, n_heads: int, dtype):
    """The mixer's output from the cell outputs ``hs`` (..., d): head-wise
    norm, then the gated feed-forward gelu(hs up1) (hs up2) down."""
    acc = hs.dtype
    hs = _headwise_rms(hs, p.head_norm, n_heads).to(dtype)
    up = gelu(dense(hs, p.up1).to(acc))
    gate = dense(hs, p.up2).to(acc)
    return dense((up * gate).to(dtype), p.down)


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), the scan over time with a checkpoint per
    ``mlstm_chunk`` steps (:func:`_scan`)."""
    B, S, d = x.shape
    H = cfg.n_heads
    wx = _slstm_wx(p, x, H).transpose(0, 1)             # (S, B, H, 4 hd)
    zeros = wx.new_zeros((B, H, d // H))
    r = p.r_gates.to(wx.dtype)
    (c, n, m, hstate), hs = _scan(
        lambda carry, xt: _slstm_step(r, carry, xt[0]), (zeros,) * 4,
        (wx,), cfg.mlstm_chunk)
    y = _slstm_out(p, hs.transpose(0, 1).reshape(B, S, d), H, x.dtype)
    if return_state:
        return y, {"c": c, "n": n, "m": m, "h": hstate}
    return y


def init_slstm_cache(cfg, batch: int, device) -> dict:
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}


def slstm_decode(p: SLSTM, x: torch.Tensor, cfg, cache: dict):
    """x: (B, 1, D) -> (B, 1, D) with the carried state."""
    B, _, d = x.shape
    H = cfg.n_heads
    wx = _slstm_wx(p, x[:, 0], H)
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    (c, n, m, hstate), hvec = _slstm_step(p.r_gates.to(wx.dtype), carry, wx)
    y = _slstm_out(p, hvec.reshape(B, 1, d), H, x.dtype)
    return y, {"c": c, "n": n, "m": m, "h": hstate}
