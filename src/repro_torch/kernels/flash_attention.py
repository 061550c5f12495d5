"""CUDA wrapper: blocked online-softmax attention (causal, GQA, optional
sliding window), the attention of every local-attention layer, and its
gradient.

Two routes, chosen from (dtype, head dim) by :func:`route` before
anything is launched, each with a forward and a backward kernel:

* ``wgmma``: bf16 with hd in 64, 128, 256. Tensor-core products (wgmma)
  fed by TMA, with a producer and two consumer warpgroups per block. The
  forward is ``csrc/flash_attention_sm90.cu`` (one block per (batch x head,
  128-row q tile)); the backward ``csrc/flash_attention_bwd_sm90.cu`` (a
  dK/dV kernel per 64-row kv tile walking the group's query heads, a dQ
  kernel per 128-row q tile).
* ``simt``: float32 (any head dim), and bf16 with hd 16 or 32. CUDA-core
  products in float32: the forward ``csrc/flash_attention.cu`` (one block
  per 64-row q tile), the backward ``csrc/flash_attention_bwd.cu``.

The backward of either route is fed the forward's per-row log-sum-exp.
On ``meta`` tensors (the dry-run, ``analysis/hlo.py``) both launchers
allocate the outputs their kernels write and report the kernels' work
(:func:`work`) to the op counter; they launch nothing.
Each file's header says what bounds it on an H100. The plain versions are
in :mod:`repro_torch.kernels.ref`.

:func:`flash_attention` and :func:`flash_attention_bwd` are the raw
launchers. Each takes CUDA tensors only, checks dtype, shape, device,
contiguity and (on the ``wgmma`` route) 16-byte alignment, allocates its
outputs, launches on PyTorch's current stream and raises on a launch
error. Neither falls back from one route to the other. Per call that
launches, each adds one to its ``launches`` and to its route's entry in
its ``route_launches``. Their outputs carry no autograd
history, so :func:`flash_attention` refuses an input that requires grad
while grad mode is on; :class:`FlashAttentionFn` is the differentiable
entry (``kernels.ops.flash_attention`` on a card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
ROUTES = ("wgmma", "simt")


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a call with this dtype and head dim launches: ``"wgmma"``
    or ``"simt"``. Raises ``TypeError``/``ValueError`` on what neither
    takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {tuple(_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def causal_pairs(S: int, window) -> int:
    """(q, k) pairs with 0 <= q - k < window (window None: q - k >= 0)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def work(B: int, Hq: int, Hkv: int, S: int, hd: int, esize: int, window,
         *, causal: bool = True, backward: bool = False,
         lse: bool = False) -> dict:
    """The least work of one call, as ``chip_smoke.py``'s bound counts
    it: operations 4 hd per unmasked (q, k) pair forward (two products),
    10 hd backward (five); an exponential per pair; bytes q, k, v read and
    the output written once (backward: q, k, v, out, dout read, dq, dk,
    dv written, and the LSE read), plus the LSE written when asked."""
    pairs = B * Hq * (causal_pairs(S, window) if causal else S * S)
    q_elems, kv_elems = B * Hq * S * hd, B * Hkv * S * hd
    if backward:
        return {"flops": 10.0 * hd * pairs, "transcendentals": float(pairs),
                "hbm_bytes": float(esize * (4 * q_elems + 4 * kv_elems)
                                   + 4 * B * Hq * S)}
    return {"flops": 4.0 * hd * pairs, "transcendentals": float(pairs),
            "hbm_bytes": float(esize * (2 * q_elems + 2 * kv_elems)
                               + (4 * B * Hq * S if lse else 0))}


def _record(name: str, which: str, dims, q, window, **kw) -> None:
    from repro_torch.analysis import hlo
    hlo.record_kernel(name, tensor_core=which == "wgmma",
                      **work(*dims, q.element_size(), window, **kw))


def _check_qkv(q, k, v, extra=()) -> tuple[int, int, int, int, int]:
    """Shapes (B, Hq, Hkv, S, hd) of q, k, v (and of the (B, Hq, S, hd)
    tensors in ``extra``), after the checks every launcher makes (meta
    tensors pass: the launchers count them, see the module docstring)."""
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: expected a 4-d torch.Tensor")
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    for name, t in (("k", k), ("v", v), *extra):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}: "
                            "all must share one")
    route(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        _lib.require_or_meta(t, name, tuple(_DTYPES), 4)
    if tuple(k.shape) != (B, Hkv, S, hd) or v.shape != k.shape \
            or k.device != q.device or v.device != q.device:
        raise ValueError(f"k and v must be ({B}, Hkv, {S}, {hd}) on q's "
                         f"device, got {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in extra:
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} on q's "
                             f"device, got {tuple(t.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    return B, Hq, Hkv, S, hd


def _check_window(window) -> None:
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _mask_args(S: int, hd: int, causal: bool, window, q) -> tuple:
    _check_window(window)
    return (_lib.int32_scalar(S, "S"), hd, int(bool(causal)),
            0 if window is None else _lib.int32_scalar(window, "window"),
            hd ** -0.5, _lib.stream_of(q))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    return_lse: bool = False):
    """q: (B, Hq, S, hd); k, v: (B, Hkv, S, hd), Hq % Hkv == 0, all of one
    dtype (float32 or bfloat16), hd in ``HEAD_DIMS``. Returns
    (B, Hq, S, hd) in q's dtype, and with ``return_lse`` also the (B, Hq,
    S) float32 log-sum-exp of each row's scaled, masked scores (the
    backward's input). ``window``: keys at least ``window`` positions
    before the query are masked (None: no window). Any S."""
    B, Hq, Hkv, S, hd = _check_qkv(q, k, v)
    which = route(q.dtype, hd)
    if q.is_meta:
        _check_window(window)
    else:
        args = _mask_args(S, hd, causal, window, q)
    _lib.refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:
        _record("flash_attention", which, (B, Hq, Hkv, S, hd), q, window,
                causal=causal, lse=return_lse)
    elif q.numel():
        lse_ptr = None if lse is None else lse.data_ptr()
        lib = _lib.load()
        if which == "wgmma":
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if any(p % 16 for p in ptrs):
                raise ValueError("flash_attention: the wgmma route needs "
                                 "16-byte aligned q, k, v")
            with _lib.on_device(q):
                code = lib.rt_flash_attention_sm90(*ptrs, lse_ptr, B, Hq,
                                                   Hkv, *args)
        else:
            with _lib.on_device(q):
                code = lib.rt_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse_ptr, _DTYPES[q.dtype], B, Hq, Hkv, *args)
        _lib.check(code, f"flash_attention ({which})")
        flash_attention.launches += 1
        flash_attention.route_launches[which] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window=None):
    """The gradient of :func:`flash_attention`: q, k, v and its ``out``
    and ``lse`` (``return_lse=True``), ``dout`` the gradient of the loss
    with respect to ``out``. Returns (dq, dk, dv) in q's dtype, each the
    shape of its input; dk and dv sum over the query heads of each kv
    head's group."""
    B, Hq, Hkv, S, hd = _check_qkv(q, k, v, (("out", out), ("dout", dout)))
    _lib.require_or_meta(lse, "lse", (torch.float32,), 3)
    if tuple(lse.shape) != (B, Hq, S) or lse.device != q.device:
        raise ValueError(f"lse must be ({B}, {Hq}, {S}) on q's device, got "
                         f"{tuple(lse.shape)}")
    which = route(q.dtype, hd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        _check_window(window)
        # the delta scratch the kernels share, held for the call
        delta = torch.empty((B, Hq, S), dtype=torch.float32,
                            device=q.device)
        _record("flash_attention_bwd", which, (B, Hq, Hkv, S, hd), q,
                window, causal=causal, backward=True)
        del delta
        return dq, dk, dv
    args = _mask_args(S, hd, causal, window, q)
    if q.numel():
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        bf16 = (q, k, v, out, dout, dq, dk, dv)
        ptrs = (*(t.data_ptr() for t in bf16[:5]), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in bf16[5:]))
        lib = _lib.load()
        if which == "wgmma":
            if any(t.data_ptr() % 16 for t in bf16):
                raise ValueError("flash_attention_bwd: the wgmma route needs "
                                 "16-byte aligned q, k, v, out and dout")
            with _lib.on_device(q):
                code = lib.rt_flash_attention_bwd_sm90(*ptrs, B, Hq, Hkv,
                                                       *args)
        else:
            with _lib.on_device(q):
                code = lib.rt_flash_attention_bwd(
                    *ptrs, _DTYPES[q.dtype], B, Hq, Hkv, *args)
        _lib.check(code, f"flash_attention_bwd ({which})")
        flash_attention_bwd.launches += 1
        flash_attention_bwd.route_launches[which] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    backward. Only when an input needs a gradient does the forward write
    the log-sum-exp and keep q, k, v, out and lse; serving (under
    ``inference_mode``) passes no lse pointer and keeps nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
