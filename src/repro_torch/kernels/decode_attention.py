"""CUDA wrapper: decode attention, one query token a sequence against its
KV cache, in one pass over the positions it attends to.

The kernels are in ``csrc/decode_attention.cu``, whose header says what
bounds them on an H100 and what the design does about GQA and a small
B x Hkv: on a bf16 cache the products run on the tensor cores, each key
and value read once for all the query heads of its kv head; on a float32
cache (the checks' dtype) on the CUDA cores, with P left unrounded. The
attended range is cut into :func:`split_count` splits, and a second,
small launch combines them in split order. The plain version is
:func:`repro_torch.kernels.ref.decode_attention`; no TPU kernel stands
behind it (the reference's decode attention is an XLA einsum).

:func:`decode_attention` takes CUDA tensors only, checks dtypes, shapes,
contiguity, 16-byte alignment, the position and the window, launches on
PyTorch's current stream, raises on a launch error and adds one to
``decode_attention.launches`` per call. On ``meta`` tensors standing for
CUDA ones (the dry-run, ``analysis/hlo.py``) it allocates the output,
reports the call's work (:func:`work`) to the op counter and launches
nothing.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
# query rows a block takes: an m16n8k16 tile on bf16, one row on float32
ROWS = {torch.bfloat16: 16, torch.float32: 1}
# positions of a tile, by head dim (csrc/decode_attention.cu,
# tile_positions)
TILE_POSITIONS = {16: 64, 32: 64, 64: 64, 128: 32, 256: 16}
# blocks a call aims for on each SM (four one-warp blocks fit at once on
# the bf16 route), and the fewest tiles a split takes
BLOCKS_PER_SM = 2
MIN_TILES = 4

_sms: dict[int, int] = {}


def attended(pos: int, window) -> tuple[int, int]:
    """(first position, number of positions) a query at ``pos`` attends
    to: [pos - window + 1, pos] with a window, [0, pos] without."""
    start = 0 if window is None else max(0, pos - window + 1)
    return start, pos - start + 1


def split_count(dtype: torch.dtype, B: int, Hq: int, Hkv: int, hd: int,
                length: int, sms: int) -> int:
    """Splits of the attended range: one when the blocks of one split
    (B x Hkv x row groups) give each of the card's ``sms`` SMs
    ``BLOCKS_PER_SM``, else as many as that takes, but at least
    ``MIN_TILES`` tiles a split. A second split costs a second launch and
    the partials' round trip, so the blocks of one split need only fill
    the card, not balance it (qwen2.5-14b's 384 at batch 48 run fastest
    unsplit on 132 SMs)."""
    rows = ROWS[dtype]
    items = B * Hkv * math.ceil(Hq // Hkv / rows)
    tiles = math.ceil(length / TILE_POSITIONS[hd])
    want = math.ceil(sms * BLOCKS_PER_SM / items)
    return max(1, min(want, tiles // MIN_TILES))


def partial_floats(dtype: torch.dtype, B: int, Hq: int, Hkv: int, hd: int,
                   splits: int) -> int:
    """float32 scratch the splits' partials take: each block's rows'
    accumulators, max and sum."""
    rows = ROWS[dtype]
    items = B * Hkv * math.ceil(Hq // Hkv / rows)
    return items * splits * rows * (hd + 2)


def work(B: int, Hq: int, Hkv: int, length: int, hd: int,
         esize: int) -> dict:
    """The least work of one call: 4 hd operations and an exponential per
    attended position and query head (two products); the keys and values
    at the attended positions read once, q read and the output written
    once."""
    pairs = B * Hq * length
    return {"flops": 4.0 * hd * pairs, "transcendentals": float(pairs),
            "hbm_bytes": float(esize * (2 * B * Hkv * length * hd
                                        + 2 * B * Hq * hd))}


def _check(q, k_cache, v_cache, pos: int, window):
    for name, t, ndim in (("q", q, 3), ("k_cache", k_cache, 4),
                          ("v_cache", v_cache, 4)):
        if not isinstance(t, torch.Tensor) or t.dim() != ndim:
            raise ValueError(f"{name}: expected a {ndim}-d torch.Tensor")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}: all "
                            "must share one")
    for name, t, ndim in (("q", q, 3), ("k_cache", k_cache, 4),
                          ("v_cache", v_cache, 4)):
        _lib.require_or_meta(t, name, tuple(_DTYPES), ndim)
    B, Hq, hd = q.shape
    _, Hkv, cap, _ = k_cache.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if tuple(k_cache.shape) != (B, Hkv, cap, hd) \
            or v_cache.shape != k_cache.shape \
            or k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError(f"k_cache and v_cache must be ({B}, Hkv, capacity, "
                         f"{hd}) on q's device, got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 0 <= pos < cap:
        raise ValueError(f"pos {pos} outside the cache's [0, {cap})")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return B, Hq, Hkv, cap, hd


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window=None,
                     splits=None) -> torch.Tensor:
    """q: (B, Hq, hd), the step's query at position ``pos``; k_cache,
    v_cache: (B, Hkv, capacity, hd), Hq % Hkv == 0, all of one dtype
    (bfloat16 or float32), hd in ``HEAD_DIMS``. Returns (B, Hq, hd) in
    q's dtype: each query head's softmax-weighted values over the cache
    positions j <= pos (with ``window``, also pos - j < window).
    ``splits`` (None: :func:`split_count`) cuts the attended range into
    that many splits; the checks set it, the model does not."""
    pos = _lib.int32_scalar(pos, "pos")
    B, Hq, Hkv, cap, hd = _check(q, k_cache, v_cache, pos, window)
    _lib.refuse_grad("decode_attention", q, k_cache, v_cache)
    _, length = attended(pos, None if window is None else int(window))
    out = torch.empty_like(q)
    if q.is_meta:
        from repro_torch.analysis import hlo
        hlo.record_kernel("decode_attention",
                          tensor_core=q.dtype == torch.bfloat16,
                          **work(B, Hq, Hkv, length, hd, q.element_size()))
        return out
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("decode_attention: q, the caches and the output "
                         "must be 16-byte aligned")
    if splits is None:
        dev = q.device.index
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(
                q.device).multi_processor_count
        splits = split_count(q.dtype, B, Hq, Hkv, hd, length, _sms[dev])
    splits = int(splits)
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    part = None
    if splits > 1:
        part = torch.empty(partial_floats(q.dtype, B, Hq, Hkv, hd, splits),
                           dtype=torch.float32, device=q.device)
    lib = _lib.load()
    with _lib.on_device(q):
        code = lib.rt_decode_attention(
            *ptrs, None if part is None else part.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, cap, hd, pos,
            0 if window is None else _lib.int32_scalar(window, "window"),
            splits, hd ** -0.5, _lib.stream_of(q))
    _lib.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
