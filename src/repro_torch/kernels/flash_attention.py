"""CUDA wrapper: blocked online-softmax attention (causal, GQA, optional
sliding window), the attention of every local-attention layer's prefill.

The kernel is in ``csrc/flash_attention.cu``: one block per (batch, query
head, 64-row query tile) loops over the kv tiles the causal mask and the
window leave (the file's header says what bounds it on an H100). The
plain version is in :mod:`repro_torch.kernels.ref`.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates the output, launches on PyTorch's current stream,
raises on a launch error, and adds one to ``flash_attention.launches``
per call that launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, S, hd), Hq % Hkv == 0, all of one
    dtype (float32 or bfloat16), hd in ``HEAD_DIMS``. Returns
    (B, Hq, S, hd) in q's dtype. ``window``: keys at least ``window``
    positions before the query are masked (None: no window). Any S."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.require(t, name, tuple(_DTYPES), 4)
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if tuple(k.shape) != (B, Hkv, S, hd) or v.shape != k.shape \
            or k.device != q.device or v.device != q.device:
        raise ValueError(f"k and v must be ({B}, Hkv, {S}, {hd}) on q's "
                         f"device, got {tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    if q.numel():
        lib = _lib.load()
        with torch.cuda.device(q.device):
            code = lib.rt_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Hq, Hkv,
                _lib.int32_scalar(S, "S"), hd, int(bool(causal)),
                0 if window is None else _lib.int32_scalar(window, "window"),
                hd ** -0.5, _lib.stream_of(q))
        _lib.check(code, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
