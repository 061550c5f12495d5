"""CUDA wrappers: vectorized snapshot resolution (paper §2.3.1).

``snapshot(v) = d(i_v), i_v = max{v' <= v}`` over a multi-version column
store, and its two-slot special case, the edge liveness mask. The kernels
are in ``csrc/snapshot_resolve.cu`` (that file's header says what bounds
them on an H100 and how they are shaped for it); the plain versions are in
:mod:`repro_torch.kernels.ref`.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, launches on PyTorch's current stream, raises on a launch
error, and adds one to its ``launches`` count per kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_RESOLVE_DTYPES = {torch.float32: 0, torch.int32: 1}


def liveness_mask(created: torch.Tensor, deleted: torch.Tensor,
                  query_version) -> torch.Tensor:
    """``created <= q < deleted`` per edge. created/deleted: (N,) int32
    data-plane-packed stamps (int32 max = never); returns (N,) bool."""
    _lib.require(created, "created", (torch.int32,), 1)
    _lib.require(deleted, "deleted", (torch.int32,), 1)
    if created.shape != deleted.shape or created.device != deleted.device:
        raise ValueError("created and deleted must match in shape and device")
    q = _lib.int32_scalar(query_version, "query_version")
    n = created.numel()
    out = torch.empty(n, dtype=torch.bool, device=created.device)
    if n:
        lib = _lib.load()
        with _lib.on_device(created):
            code = lib.rt_liveness_mask(
                created.data_ptr(), deleted.data_ptr(), q, out.data_ptr(), n,
                _lib.stream_of(created))
        _lib.check(code, "liveness_mask")
        liveness_mask.launches += 1
    return out


liveness_mask.launches = 0


def snapshot_resolve(versions: torch.Tensor, values: torch.Tensor,
                     query_version) -> tuple[torch.Tensor, torch.Tensor]:
    """versions: (N, K) int32 ascending (pad = int32 max); values: (N, K)
    float32 or int32; query_version: int32 scalar. Returns (resolved (N,)
    of values' dtype, 0 where nothing resolves; index (N,) int32, -1 for
    items with no version <= query)."""
    _lib.require(versions, "versions", (torch.int32,), 2)
    _lib.require(values, "values", tuple(_RESOLVE_DTYPES), 2)
    if versions.shape != values.shape or versions.device != values.device:
        raise ValueError("versions and values must match in shape and device")
    q = _lib.int32_scalar(query_version, "query_version")
    n, k = versions.shape
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    index = torch.empty(n, dtype=torch.int32, device=values.device)
    if n:
        lib = _lib.load()
        with _lib.on_device(values):
            code = lib.rt_snapshot_resolve(
                versions.data_ptr(), values.data_ptr(),
                _RESOLVE_DTYPES[values.dtype], q, out.data_ptr(),
                index.data_ptr(), n, k, _lib.stream_of(values))
        _lib.check(code, "snapshot_resolve")
        snapshot_resolve.launches += 1
    return out, index


snapshot_resolve.launches = 0
