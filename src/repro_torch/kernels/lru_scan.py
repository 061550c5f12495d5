"""CUDA wrapper: diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``
(the RG-LRU inner loop of every recurrent layer), and its gradient.

The kernels are in ``csrc/lru_scan.cu`` (its header says what bounds each
on an H100 and the occupancy arithmetic). The scan is one pass over
device memory, as the TPU kernel's: a block owns (batch, 32 channels) and
walks time in segments of ``SCAN_WARPS`` warps x ``SCAN_STEPS`` steps;
each warp scans its steps in registers with no carry in, the warps'
aggregates are folded in warp order from the segment's carry (a fixed
order, so two calls give the same bits), and each warp rescans from its
carry. Nothing crosses between blocks: no scratch, no second pass. The
gradient is a chunked scan over time in two launches, one thread per
(batch, chunk of ``BWD_CHUNK`` steps, channel), with a (2, B, n_chunks, C)
float32 scratch of per-chunk carries that :func:`lru_scan_bwd` allocates.
The plain versions are in :mod:`repro_torch.kernels.ref`. On ``meta``
tensors (the dry-run, ``analysis/hlo.py``) both launchers allocate the
outputs and scratch their kernels write and report the kernels' work
(:func:`work`) to the op counter; they launch nothing.

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

# the forward's segment: warps per block, and time steps per warp; passed
# to the kernel, whose C entry is built for this pair only and refuses any
# other (the other pairs timed on an H100 were no faster, PERF.md)
SCAN_WARPS, SCAN_STEPS = 8, 16
# time steps per chunk of the backward's chunked scan; passed to the kernel
BWD_CHUNK = 64


def work(B: int, S: int, C: int, *, backward: bool = False) -> dict:
    """The least work of one call, as the kernel table's bound counts it
    (bytes over the card's memory rate, operations over its float32 peak;
    n = B S C float32 elements): forward a, b read and h written (12 n
    bytes), a multiply and an add a step (2 n); backward a, h, dh read and
    da, db written (20 n bytes), 3 n operations."""
    n = B * S * C
    if backward:
        return {"flops": 3.0 * n, "hbm_bytes": 20.0 * n}
    return {"flops": 2.0 * n, "hbm_bytes": 12.0 * n}


def _record(name: str, B: int, S: int, C: int, **kw) -> None:
    from repro_torch.analysis import hlo
    hlo.record_kernel(name, tensor_core=False, **work(B, S, C, **kw))


def _check_h0(h0, B: int, C: int, like: torch.Tensor, name: str) -> None:
    _lib.require_or_meta(h0, name, (torch.float32,), 2)
    if tuple(h0.shape) != (B, C) or h0.device != like.device:
        raise ValueError(f"{name} must be ({B}, {C}) on a's device, got "
                         f"{tuple(h0.shape)} on {h0.device}")


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, S, C) float32 -> h: (B, S, C) float32, with
    h_0 = a_0 * h0 + b_0 (h0: (B, C) float32, zeros when None). Any S."""
    _lib.require_or_meta(a, "a", (torch.float32,), 3)
    _lib.require_or_meta(b, "b", (torch.float32,), 3)
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b {tuple(b.shape)} must match a {tuple(a.shape)} "
                         "on a's device")
    B, S, C = a.shape
    if h0 is not None:
        _check_h0(h0, B, C, a, "h0")
    _lib.refuse_grad("lru_scan", a, b, h0)
    out = torch.empty_like(a)
    if a.is_meta:
        _record("lru_scan", B, S, C)
    elif a.numel():
        lib = _lib.load()
        with _lib.on_device(a):
            code = lib.rt_lru_scan(
                a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), out.data_ptr(),
                B, S, C, SCAN_WARPS, SCAN_STEPS, _lib.stream_of(a))
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
        _lib.require_or_meta(t, name, (torch.float32,), 3)
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
        n_chunks = -(-S // BWD_CHUNK)
        carry = torch.empty((2, B, n_chunks, C), dtype=torch.float32,
                            device=a.device)
        if a.is_meta:
            _record("lru_scan_bwd", B, S, C, backward=True)
            return da, db, dh0
        lib = _lib.load()
        stream = _lib.stream_of(a)
        with _lib.on_device(a):
            code = lib.rt_lru_scan_bwd_carry(
                a.data_ptr(), dh.data_ptr(), carry.data_ptr(), B, S, C,
                BWD_CHUNK, stream)
            if not code:
                code = lib.rt_lru_scan_bwd(
                    a.data_ptr(), h.data_ptr(),
                    None if h0 is None else h0.data_ptr(), dh.data_ptr(),
                    carry.data_ptr(), da.data_ptr(), db.data_ptr(),
                    None if dh0 is None else dh0.data_ptr(), B, S, C,
                    BWD_CHUNK, stream)
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
