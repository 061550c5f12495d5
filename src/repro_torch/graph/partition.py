"""Distributed graph execution — partitioning + replica-coherence mirrors.

The paper's data manager adjusts partitions and replicas from access
patterns. The reference runs its partitions as SPMD shards of a device
mesh; the port runs the P partitions on the one device the graph's
tensors live on, as P rows of one batched computation. The collectives
become reductions over that row axis, and "replicas" are still one of

  * **all-gather mode** — every partition replicates all vertex values per
    superstep (maximal replication: cheapest compute, highest traffic), or
  * **scatter mode** — edge-to-src-partition placement with per-partition
    partial aggregates merged by a reduce-scatter (no replication), or
  * **hub-mirror mode** — the replica-coherence policy: only high-degree
    ("hub") vertex values are mirrored everywhere (Trinity's hub buffering /
    PowerGraph vertex-cut insight); the tail uses the scatter path.

Access statistics that drive the hub set are exactly the out-degrees (how
often a vertex's value is read by other partitions), i.e. the paper's
"predictive model of the data access pattern".

``comm_model()`` reports the per-superstep bytes each mode would move
between P devices over ring collectives, so the policy's decision can be
checked analytically: on one device no bytes cross a link.

Partitions are built on the host in NumPy, with the reference's own
operations (the same ``np.argsort`` picks the same hubs among equal
degrees), and the finished arrays are tensors on the view's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import to_host
from repro_torch.graph.dyngraph import JoinView


@dataclasses.dataclass
class PartitionedGraph:
    n: int                      # padded global vertex count (divisible by P)
    n_parts: int
    # edges grouped by SOURCE partition, padded to uniform length
    src: torch.Tensor           # (P, m_pad) int32 global src ids
    dst: torch.Tensor           # (P, m_pad) int32 global dst ids
    mask: torch.Tensor          # (P, m_pad) bool validity
    out_degree: torch.Tensor    # (n,) float32
    hubs: torch.Tensor          # (k,) int32 global ids of mirrored hubs
    is_hub: torch.Tensor        # (n,) bool
    # "src": contiguous src-range placement (edge values local at scatter
    # time — all modes valid). "dst_hash": pre-sharded by destination hash
    # (the ShardedDynamicGraph layout — allgather mode only).
    placement: str = "src"

    @property
    def n_local(self) -> int:
        return self.n // self.n_parts


def _finish(n, n_parts, ps, pd, pm, deg, hub_k, device,
            placement="src") -> PartitionedGraph:
    """Pick the hubs (the ``hub_k`` largest out-degrees, ``np.argsort``'s
    order among ties) and move the host arrays to ``device``."""
    hubs = np.argsort(-deg)[:hub_k].astype(np.int32) if hub_k else \
        np.zeros(0, np.int32)
    is_hub = np.zeros(n, bool)
    is_hub[hubs] = True
    return PartitionedGraph(
        n, n_parts, *(torch.from_numpy(a).to(device)
                      for a in (ps, pd, pm, deg, hubs, is_hub)),
        placement=placement)


def partition_graph(view: JoinView, n_parts: int, *, hub_k: int = 0,
                    pad_to: int | None = None) -> PartitionedGraph:
    """Contiguous-range vertex partitioning; edges placed at their source's
    partition (values are local at scatter time). The tensors live on the
    view's device."""
    n = ((view.n + n_parts - 1) // n_parts) * n_parts
    n_local = n // n_parts
    src = to_host(view.src)
    dst = to_host(view.dst)
    part_of = src // n_local
    m_pad = pad_to or max(1, int(np.bincount(part_of, minlength=n_parts).max()))
    ps = np.zeros((n_parts, m_pad), np.int32)
    pd = np.zeros((n_parts, m_pad), np.int32)
    pm = np.zeros((n_parts, m_pad), bool)
    for p in range(n_parts):
        idx = np.flatnonzero(part_of == p)[:m_pad]
        ps[p, :len(idx)] = src[idx]
        pd[p, :len(idx)] = dst[idx]
        pm[p, :len(idx)] = True
    deg = np.zeros(n, np.float32)
    deg[:view.n] = to_host(view.out_degree)
    return _finish(n, n_parts, ps, pd, pm, deg, hub_k, view.src.device)


def partition_graph_sharded(shard_views, *, hub_k: int = 0,
                            pad_to: int | None = None,
                            placement: str = "dst_hash") -> PartitionedGraph:
    """Build a PartitionedGraph from pre-sharded per-shard join views
    (``ShardedDynamicGraph.shard_views``), from their host arrays.

    ``placement="dst_hash"`` (default) is the zero-copy fast path: each
    shard's rows ARE its partition's rows, so construction is one padded
    copy per shard — but only the ``allgather`` compute mode is valid
    (partial aggregates merge by the reduce-scatter regardless of edge
    placement). ``placement="src"`` re-buckets the concatenated shard
    rows by source range in one vectorized grouping pass (no O(P·m)
    mask-and-gather like ``partition_graph``), making every edge's source
    value local to its partition — which is what unlocks the
    ``scatter``/``hub`` modes of ``distributed_join_group_by``, i.e. lets
    hub-mirror placement compose with the sharded store's views.
    """
    if not shard_views:
        raise ValueError("no shard views")
    if placement not in ("dst_hash", "src"):
        raise ValueError(f"unknown placement {placement!r}")
    n_parts = len(shard_views)
    n = ((shard_views[0].n + n_parts - 1) // n_parts) * n_parts
    deg = np.zeros(n, np.float32)
    for view in shard_views:
        deg[:view.n] += view.np_out_deg
    if placement == "src":
        n_local = n // n_parts
        src = np.concatenate([v.np_src for v in shard_views])
        dst = np.concatenate([v.np_dst for v in shard_views])
        part_of = src // n_local
        order = np.argsort(part_of, kind="stable")
        counts = np.bincount(part_of, minlength=n_parts)
        widest = max(1, int(counts.max()))
        m_pad = pad_to or widest
        if m_pad < widest:
            raise ValueError(
                f"pad_to={m_pad} would silently drop edges (widest "
                f"partition has {widest}); pass pad_to >= {widest}")
        ps = np.zeros((n_parts, m_pad), np.int32)
        pd = np.zeros((n_parts, m_pad), np.int32)
        pm = np.zeros((n_parts, m_pad), bool)
        bounds = np.r_[0, np.cumsum(counts)]
        for p in range(n_parts):
            rows = order[bounds[p]:bounds[p + 1]]
            ps[p, :len(rows)] = src[rows]
            pd[p, :len(rows)] = dst[rows]
            pm[p, :len(rows)] = True
    else:
        widest = max(v.m for v in shard_views)
        m_pad = pad_to or max(1, widest)
        if m_pad < widest:
            raise ValueError(
                f"pad_to={m_pad} would silently drop edges (widest shard "
                f"has {widest}); pass pad_to >= {widest}")
        ps = np.zeros((n_parts, m_pad), np.int32)
        pd = np.zeros((n_parts, m_pad), np.int32)
        pm = np.zeros((n_parts, m_pad), bool)
        for p, view in enumerate(shard_views):
            m = view.m
            ps[p, :m] = view.np_src
            pd[p, :m] = view.np_dst
            pm[p, :m] = True
    return _finish(n, n_parts, ps, pd, pm, deg, hub_k,
                   shard_views[0].src.device, placement)


# spare columns past n that take the masked-out rows' zeros, spread so
# that the padding's adds do not all land on one address (dst 0)
_SPARE = 1024


def local_partials(pg: PartitionedGraph, vals: torch.Tensor) -> torch.Tensor:
    """(P, n) per-partition partial aggregates: row p scatter-adds
    ``vals[p][src_p] * mask_p`` into dst_p, as the reference's
    ``_local_partials`` does on each device. ``vals`` is (n,) (every
    partition reads the same values) or (P, n), as :func:`mode_values`
    gives them.

    The mask multiplies, as in the reference, so a masked-out row adds 0
    times its value: nothing to a sum that starts at +0, unless that value
    is not finite. Those rows therefore add into spare columns past n
    (the padding points at dst 0, and ten million adds to one address
    serialize on a card), except a non-finite product, which reaches its
    dst as in the reference."""
    n = pg.n
    src = pg.src.long()
    contrib = vals[src] if vals.dim() == 1 else torch.gather(vals, 1, src)
    contrib = contrib * pg.mask
    spare = n + torch.arange(contrib.shape[1], device=contrib.device) % _SPARE
    dst = torch.where(pg.mask | ~torch.isfinite(contrib), pg.dst.long(),
                      spare)
    out = torch.zeros((pg.n_parts, n + _SPARE), dtype=contrib.dtype,
                      device=contrib.device)
    return out.scatter_add_(1, dst, contrib)[:, :n]


def mode_values(pg: PartitionedGraph, values: torch.Tensor,
                mode: str) -> torch.Tensor:
    """The vertex values each partition reads in ``mode``: the whole (n,)
    ``values`` for ``allgather`` (the all-gather), else a (P, n) tensor
    whose row p holds partition p's own slice, zeros elsewhere, and in
    ``hub`` mode every hub's value mirrored into every row."""
    n, nl, P = pg.n, pg.n_local, pg.n_parts
    if pg.placement != "src" and mode in ("scatter", "hub"):
        raise ValueError(
            f"mode {mode!r} needs src-placed edges (local values at scatter "
            f"time); this graph is {pg.placement!r}-placed — use 'allgather'")
    if mode == "allgather":
        return values.reshape(n)
    if mode not in ("scatter", "hub"):
        raise ValueError(mode)
    local = values.reshape(P, nl)
    # local values only: every edge's src IS local to its partition
    rows = torch.arange(P, device=values.device)
    vals = torch.zeros((P, P, nl), dtype=values.dtype, device=values.device)
    vals[rows, rows] = local
    vals = vals.reshape(P, n)
    if mode == "hub":
        # each partition offers its own hubs' values (times 0 for the
        # others, as the reference masks them), summed over partitions
        hubs = pg.hubs.long()
        lo = (rows * nl)[:, None]
        owned = (hubs[None, :] >= lo) & (hubs[None, :] < lo + nl)
        offered = torch.gather(local, 1,
                               torch.clamp(hubs[None, :] - lo, 0, nl - 1))
        vals[:, hubs] = (offered * owned).sum(0)     # (k,) replicated
    return vals


def distributed_join_group_by(pg: PartitionedGraph, values: torch.Tensor, *,
                              mode: str = "scatter") -> torch.Tensor:
    """values: (n,), partition p owning rows [p * n_local, (p+1) * n_local).
    Returns the (n,) aggregate, laid out the same way.

    The reference takes a device mesh and runs each partition on its own
    device; here the P partitions run on the device of ``pg``'s tensors,
    as P rows of one batched computation, so there is no ``mesh``
    argument. The reference's collectives become reductions over the row
    axis: the all-gather is every row reading the whole ``values``, the
    hub ``psum`` a sum over rows (:func:`mode_values`), and the tiled
    ``psum_scatter`` the sum of the P partial vectors, whose slice p is
    partition p's output. The partials take P x n x 4 bytes of device
    memory (64 MB at P = 16, n = 2^20)."""
    return local_partials(pg, mode_values(pg, values, mode)).sum(0)


def comm_model(pg: PartitionedGraph, *, bytes_per_value: int = 4) -> dict:
    """Per-superstep bytes moved per device, by mode (ring collectives).
    This is the access-pattern model the replica-coherence policy consults."""
    p = pg.n_parts
    n = pg.n
    k = int(pg.hubs.shape[0])
    ag = (p - 1) / p * n * bytes_per_value          # all-gather values
    ps = (p - 1) / p * n * bytes_per_value          # psum-scatter partials
    return {
        "allgather": ag + ps,
        "scatter": ps,
        "hub": ps + 2 * (p - 1) / p * k * bytes_per_value,
        "n": n, "parts": p, "hubs": k,
    }
