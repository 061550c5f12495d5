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

from repro_torch.device import stands_for
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lru_scan as _lru
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import snapshot_resolve as _sr
from repro_torch.kernels import wcc as _wcc

# the CUDA wrappers, each carrying its own ``launches`` count
_WRAPPERS = {"liveness_mask": _sr.liveness_mask,
             "snapshot_resolve": _sr.snapshot_resolve,
             "segment_sum": _ss.segment_sum,
             "lru_scan": _lru.lru_scan,
             "lru_scan_bwd": _lru.lru_scan_bwd,
             "flash_attention": _fa.flash_attention,
             "flash_attention_bwd": _fa.flash_attention_bwd,
             "wcc_round": _wcc.wcc_round,
             "decode_attention": _da.decode_attention}


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device, or is a meta tensor that
    stands for one (``device.meta_as``)."""
    return stands_for(t.device).type == "cuda"


def wants_kernel(t: torch.Tensor, use_kernel) -> bool:
    """Resolve ``use_kernel`` against the tensor that would feed the
    kernel (see the module docstring). A meta tensor that stands for a
    CUDA one (``device.meta_as``) resolves as a CUDA tensor: the
    wrapper then counts the kernel's work for the dry-run and launches
    nothing."""
    card = on_card(t)
    if use_kernel is None:
        return card
    if use_kernel and not card:
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


def decode_attention(q, k_cache, v_cache, pos, *, window=None,
                     use_kernel=None):
    """A decode step's attention: (B, Hq, hd) ``q`` at position ``pos``
    (an int, or a one-element int32 tensor on q's device) over the (B,
    Hkv, capacity, hd) caches' positions up to it (with ``window``, the
    last ``window`` of them); (B, Hq, hd) in q's dtype."""
    if wants_kernel(q, use_kernel):
        return _da.decode_attention(q, k_cache, v_cache, pos, window=window)
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)


def wcc_round(src, dst, labels, *, out=None, changed=None, use_kernel=None):
    """One synchronous round of WCC's min-label propagation over the int32
    edges (``src``, ``dst``): (labels after the round, (1,) int32 flag,
    nonzero if any label fell). The kernel route writes into ``out`` and
    ``changed`` where given (allocated otherwise); the plain route allocates
    both."""
    if wants_kernel(labels, use_kernel):
        if out is None:
            out = torch.empty_like(labels)
        if changed is None:
            changed = torch.empty(1, dtype=torch.int32, device=labels.device)
        _wcc.wcc_round(src, dst, labels, out, changed)
        return out, changed
    return ref.wcc_round(src, dst, labels)


# the decode step's CUDA graph (``launch/steps.py``): its captures, and its
# replays, one a decode step it takes
GRAPH_COUNTS = dict.fromkeys(("decode_graph.captures",
                              "decode_graph.replays"), 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches per CUDA wrapper since the last reset. A launch
    count counts host issues: a decode step captured in a CUDA graph
    counts its kernels once for the capture (and once for the eager
    warm-up before it), and the graph's replays count nothing
    (:func:`graph_counts` counts them)."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def graph_counts() -> dict[str, int]:
    """The decode graph's ``decode_graph.captures`` and
    ``decode_graph.replays`` since the last :func:`reset_launch_counts`."""
    return dict(GRAPH_COUNTS)


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
    for name in GRAPH_COUNTS:
        GRAPH_COUNTS[name] = 0
    for fn in _ROUTED.values():
        fn.route_launches = dict.fromkeys(_fa.ROUTES, 0)
