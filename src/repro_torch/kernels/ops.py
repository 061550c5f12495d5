"""Public kernel entry points of the port: one switch between the
hand-written CUDA kernels and their plain versions.

It takes the place of the reference's interpret switch
(``repro/kernels/ops.py``). ``use_kernel`` decides per call:

* ``None`` (default) follows the tensor's device: a CUDA tensor goes to the
  CUDA kernel, a CPU tensor to the plain version in :mod:`.ref`;
* ``False`` forces the plain version (on whatever device the tensor is);
* ``True`` demands the kernel and raises on a CPU tensor.

There is no fallback: a CUDA launch that fails raises. ``lru_scan`` and
``flash_attention`` are differentiable on both routes: on the kernel route
through the autograd Functions of their wrapper modules, whose backwards
are the CUDA kernels ``lru_scan_bwd`` and ``flash_attention_bwd``; on the
plain route by autograd of the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lru_scan as _lru
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import snapshot_resolve as _sr

# the CUDA wrappers, each carrying its own ``launches`` count
_WRAPPERS = {"liveness_mask": _sr.liveness_mask,
             "snapshot_resolve": _sr.snapshot_resolve,
             "segment_sum": _ss.segment_sum,
             "lru_scan": _lru.lru_scan,
             "lru_scan_bwd": _lru.lru_scan_bwd,
             "flash_attention": _fa.flash_attention,
             "flash_attention_bwd": _fa.flash_attention_bwd}


def wants_kernel(t: torch.Tensor, use_kernel) -> bool:
    """Resolve ``use_kernel`` against the tensor that would feed the
    kernel (see the module docstring)."""
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; this one is "
                         f"on {t.device}")
    return bool(use_kernel)


def segment_sum(values, segment_ids, num_segments, *, use_kernel=None):
    if wants_kernel(values, use_kernel):
        return _ss.segment_sum(values, segment_ids, num_segments)
    return ref.segment_sum(values, segment_ids, num_segments)


def snapshot_resolve(versions, values, query_version, *, use_kernel=None):
    if wants_kernel(values, use_kernel):
        return _sr.snapshot_resolve(versions, values, query_version)
    return ref.snapshot_resolve(versions, values, query_version)


def liveness_mask(created, deleted, query_version, *, use_kernel=None):
    """Snapshot-mask hot path on the int32 data-plane stamp packing the
    graph store keeps natively (sentinel = int32 max)."""
    if wants_kernel(created, use_kernel):
        return _sr.liveness_mask(created, deleted, query_version)
    return ref.liveness_mask(created, deleted, query_version)


def lru_scan(a, b, h0=None, *, use_kernel=None):
    """RG-LRU recurrence over axis 1 of (B, S, C) float32 ``a``, ``b``."""
    if wants_kernel(a, use_kernel):
        return _lru.LruScanFn.apply(a, b, h0)
    return ref.lru_scan(a, b, h0)


def flash_attention(q, k, v, *, causal=True, window=None, use_kernel=None):
    """Attention of (B, Hq, S, hd) ``q`` over (B, Hkv, S, hd) ``k``, ``v``."""
    if wants_kernel(q, use_kernel):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def launch_counts() -> dict[str, int]:
    """Kernel launches per CUDA wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


# the wrappers with more than one kernel, each carrying ``route_launches``
_ROUTED = {"flash_attention": _fa.flash_attention,
           "flash_attention_bwd": _fa.flash_attention_bwd}


def route_counts() -> dict[str, dict[str, int]]:
    """Launches per route of the wrappers that have more than one kernel
    (``flash_attention`` and ``flash_attention_bwd``: ``wgmma`` and
    ``simt``) since the last reset."""
    return {name: dict(fn.route_launches) for name, fn in _ROUTED.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for fn in _ROUTED.values():
        fn.route_launches = dict.fromkeys(_fa.ROUTES, 0)
