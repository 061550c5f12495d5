"""CUDA wrapper: diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``
(the RG-LRU inner loop of every recurrent layer), and its gradient.

The kernels are in ``csrc/lru_scan.cu``: one thread per (batch, channel)
walks time, forwards for the scan and backwards for its gradient (the
file's header says what bounds each on an H100). The plain versions are in
:mod:`repro_torch.kernels.ref`.

:func:`lru_scan` and :func:`lru_scan_bwd` are the raw launchers. Each takes
CUDA tensors only, checks device, dtype, shape and contiguity, allocates
its outputs, launches on PyTorch's current stream, raises on a launch
error, and adds one to its ``launches`` per call that launches. Their
outputs carry no autograd history, so :func:`lru_scan` refuses an input
that requires grad while grad mode is on; :class:`LruScanFn` is the
differentiable entry (``kernels.ops.lru_scan`` on a card), whose backward
is :func:`lru_scan_bwd`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def _check_h0(h0, B: int, C: int, like: torch.Tensor, name: str) -> None:
    _lib.require(h0, name, (torch.float32,), 2)
    if tuple(h0.shape) != (B, C) or h0.device != like.device:
        raise ValueError(f"{name} must be ({B}, {C}) on a's device, got "
                         f"{tuple(h0.shape)} on {h0.device}")


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, S, C) float32 -> h: (B, S, C) float32, with
    h_0 = a_0 * h0 + b_0 (h0: (B, C) float32, zeros when None). Any S."""
    _lib.require(a, "a", (torch.float32,), 3)
    _lib.require(b, "b", (torch.float32,), 3)
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b {tuple(b.shape)} must match a {tuple(a.shape)} "
                         "on a's device")
    B, S, C = a.shape
    if h0 is not None:
        _check_h0(h0, B, C, a, "h0")
    _lib.refuse_grad("lru_scan", a, b, h0)
    out = torch.empty_like(a)
    if a.numel():
        lib = _lib.load()
        with _lib.on_device(a):
            code = lib.rt_lru_scan(
                a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), out.data_ptr(),
                B, S, C, _lib.stream_of(a))
        _lib.check(code, "lru_scan")
        lru_scan.launches += 1
    return out


lru_scan.launches = 0


def lru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                 h0: torch.Tensor | None = None, *, want_dh0: bool = False):
    """The gradient of :func:`lru_scan`. a: the scan's coefficients, h: its
    output, dh: the gradient of the loss with respect to h, all (B, S, C)
    float32; h0 as given to the scan. Returns (da, db, dh0), dh0 (B, C)
    when ``want_dh0`` (and h0 is given), else None."""
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        _lib.require(t, name, (torch.float32,), 3)
        if t.shape != a.shape or t.device != a.device:
            raise ValueError(f"{name} {tuple(t.shape)} must match a "
                             f"{tuple(a.shape)} on a's device")
    B, S, C = a.shape
    if h0 is not None:
        _check_h0(h0, B, C, a, "h0")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (torch.empty((B, C), dtype=torch.float32, device=a.device)
           if want_dh0 and h0 is not None else None)
    if a.numel():
        lib = _lib.load()
        with _lib.on_device(a):
            code = lib.rt_lru_scan_bwd(
                a.data_ptr(), h.data_ptr(),
                None if h0 is None else h0.data_ptr(), dh.data_ptr(),
                da.data_ptr(), db.data_ptr(),
                None if dh0 is None else dh0.data_ptr(), B, S, C,
                _lib.stream_of(a))
        _lib.check(code, "lru_scan_bwd")
        lru_scan_bwd.launches += 1
    elif dh0 is not None:
        dh0.zero_()
    return da, db, dh0


lru_scan_bwd.launches = 0


class LruScanFn(torch.autograd.Function):
    """:func:`lru_scan` with :func:`lru_scan_bwd` as its backward. The
    forward keeps a, h and h0 for the backward only when an input needs a
    gradient (serving under ``inference_mode`` keeps nothing)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        with torch.no_grad():
            h = lru_scan(a, b, h0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = lru_scan_bwd(a, h, dh.contiguous(), h0,
                                   want_dh0=ctx.needs_input_grad[2])
        return da, db, dh0
