"""Public kernel entry points of the port: one switch between the
hand-written CUDA kernels and their plain versions.

It takes the place of the reference's interpret switch
(``repro/kernels/ops.py``). ``use_kernel`` decides per call:

* ``None`` (default) follows the tensor's device: a CUDA tensor goes to the
  CUDA kernel, a CPU tensor to the plain version in :mod:`.ref`;
* ``False`` forces the plain version (on whatever device the tensor is);
* ``True`` demands the kernel and raises on a CPU tensor.

There is no fallback: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import snapshot_resolve as _sr

# the CUDA wrappers, each carrying its own ``launches`` count
_WRAPPERS = {"liveness_mask": _sr.liveness_mask,
             "snapshot_resolve": _sr.snapshot_resolve,
             "segment_sum": _ss.segment_sum}


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


def launch_counts() -> dict[str, int]:
    """Kernel launches per CUDA wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
