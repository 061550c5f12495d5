"""CUDA wrapper: sorted segment sum (the join-group-by hot spot).

The kernel is in ``csrc/segment_sum.cu``: one launch, one pass over the
ids and values, no scratch; each block (F = 1) or warp (F > 1) owns the
segments that start in its chunk of rows (the file's header says what
bounds it on an H100). The plain version is in
:mod:`repro_torch.kernels.ref`.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates the output, launches once on PyTorch's current
stream, raises on a launch error, and adds one to ``segment_sum.launches``
per call that launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (m, F) float32 or bfloat16, rows sorted by segment;
    segment_ids: (m,) int32 ascending. Returns (num_segments, F) float32.
    Ids outside [0, num_segments) — the phantom padding segment — are
    dropped; empty segments are 0; sums accumulate in float32."""
    _lib.require(values, "values", tuple(_DTYPES), 2)
    _lib.require(segment_ids, "segment_ids", (torch.int32,), 1)
    if segment_ids.shape[0] != values.shape[0] \
            or segment_ids.device != values.device:
        raise ValueError("segment_ids must have one entry per value row, on "
                         "the values' device")
    n = int(num_segments)
    if n < 0:
        raise ValueError(f"num_segments must be >= 0, got {n}")
    f = values.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=values.device)
    if n and f:
        lib = _lib.load()
        with _lib.on_device(values):
            code = lib.rt_segment_sum(
                values.data_ptr(), _DTYPES[values.dtype],
                segment_ids.data_ptr(), out.data_ptr(), values.shape[0], n,
                f, _lib.stream_of(values))
        _lib.check(code, "segment_sum")
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
