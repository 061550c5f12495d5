"""CUDA wrapper: diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``
(the RG-LRU inner loop of every recurrent layer's prefill).

The kernel is in ``csrc/lru_scan.cu``: one thread per (batch, channel)
walks time (the file's header says what bounds it on an H100). The plain
version is in :mod:`repro_torch.kernels.ref`.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates the output, launches on PyTorch's current stream,
raises on a launch error, and adds one to ``lru_scan.launches`` per call
that launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


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
        _lib.require(h0, "h0", (torch.float32,), 2)
        if tuple(h0.shape) != (B, C) or h0.device != a.device:
            raise ValueError(f"h0 must be ({B}, {C}) on a's device, got "
                             f"{tuple(h0.shape)} on {h0.device}")
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
