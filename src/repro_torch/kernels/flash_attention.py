"""CUDA wrapper: blocked online-softmax attention (causal, GQA, optional
sliding window), the attention of every local-attention layer's prefill.

Two kernels, two routes, chosen from (dtype, head dim) by :func:`route`
before anything is launched:

* ``wgmma`` (``csrc/flash_attention_sm90.cu``): bf16 with hd in 64, 128,
  256. Tensor-core products (wgmma) fed by TMA, one block per (batch x head,
  128-row q tile) with a producer and two consumer warpgroups.
* ``simt`` (``csrc/flash_attention.cu``): float32, and bf16 with hd 16 or
  32. CUDA-core products in float32, one block per 64-row q tile.

Each file's header says what bounds it on an H100. The plain version is in
:mod:`repro_torch.kernels.ref`.

The wrapper takes CUDA tensors only, checks dtype, shape, device,
contiguity and (on the ``wgmma`` route) 16-byte alignment, allocates the
output, launches on PyTorch's current stream and raises on a launch error.
It never falls back from one route to the other. Per call that launches it
adds one to ``flash_attention.launches`` and to its route's entry in
``flash_attention.route_launches``.
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, S, hd), Hq % Hkv == 0, all of one
    dtype (float32 or bfloat16), hd in ``HEAD_DIMS``. Returns
    (B, Hq, S, hd) in q's dtype. ``window``: keys at least ``window``
    positions before the query are masked (None: no window). Any S."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: expected a 4-d torch.Tensor")
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    which = route(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.require(t, name, tuple(_DTYPES), 4)
    if tuple(k.shape) != (B, Hkv, S, hd) or v.shape != k.shape \
            or k.device != q.device or v.device != q.device:
        raise ValueError(f"k and v must be ({B}, Hkv, {S}, {hd}) on q's "
                         f"device, got {tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    if not q.numel():
        return out
    args = (_lib.int32_scalar(S, "S"), hd, int(bool(causal)),
            0 if window is None else _lib.int32_scalar(window, "window"),
            hd ** -0.5, _lib.stream_of(q))
    lib = _lib.load()
    if which == "wgmma":
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if any(p % 16 for p in ptrs):
            raise ValueError("flash_attention: the wgmma route needs "
                             "16-byte aligned q, k, v")
        with _lib.on_device(q):
            code = lib.rt_flash_attention_sm90(*ptrs, B, Hq, Hkv, *args)
    else:
        with _lib.on_device(q):
            code = lib.rt_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Hq, Hkv, *args)
    _lib.check(code, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
