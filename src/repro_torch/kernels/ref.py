"""Plain PyTorch versions of the port's kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the oracle every CUDA kernel is held
against on the card. Same semantics as the Pallas functions they stand
for (``repro/kernels/snapshot_resolve.py``, ``repro/kernels/segment_sum.py``).
"""
from __future__ import annotations

import torch


def liveness_mask(created: torch.Tensor, deleted: torch.Tensor,
                  query_version) -> torch.Tensor:
    """``created <= q < deleted`` per edge -> (N,) bool. Equal to the
    reference's 2-slot resolve ([created, deleted] -> [1, 0]) for every
    stamp pair, ascending or not."""
    q = int(query_version)
    return (created <= q) & (q < deleted)


def snapshot_resolve(versions: torch.Tensor, values: torch.Tensor,
                     query_version) -> tuple[torch.Tensor, torch.Tensor]:
    """(resolved (N,), index (N,) int32): the value at the largest slot
    whose version is <= q (0 if none) and that slot (-1 if none)."""
    n, k = versions.shape
    if n == 0:
        return (torch.zeros(0, dtype=values.dtype, device=values.device),
                torch.zeros(0, dtype=torch.int32, device=values.device))
    slot = torch.arange(k, dtype=torch.int32, device=versions.device)
    best = torch.where(versions <= int(query_version), slot,
                       torch.full_like(slot, -1)).amax(dim=1)
    gathered = values.gather(1, best.clamp(min=0).long()[:, None])[:, 0]
    resolved = torch.where(best >= 0, gathered, torch.zeros_like(gathered))
    return resolved, best


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (m, F); segment_ids: (m,) -> (num_segments, F) float32.
    Ids outside [0, num_segments) (the phantom padding row) are dropped,
    and the sum is taken in float32 whatever the input type."""
    f = values.shape[1]
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=values.device)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    out.index_add_(0, segment_ids[keep].long(), values[keep].float())
    return out
