"""Graph computing on protocol dataflow — paper §2.3.3.2.

The core primitive is **join-group-by**: join each vertex with its neighbors'
values, group by destination, reduce. With the per-snapshot CSR (*join view*)
this is a segment reduction — the hand-written ``segment_sum`` CUDA kernel on
a CUDA view, a plain scatter-add on the CPU (``use_kernel`` overrides; see
:mod:`repro_torch.kernels.ops`).

On top of it: PageRank (offline, full) and **incremental PageRank** (online:
warm-start from the previous snapshot's result — the paper's
"adapt to the graph changes first, then reschedule on the entire graph"),
SSSP with *priority scheduling* (the paper's Dijkstra-via-priority-queue
example), WCC, degree/temporal analytics, and online BFS/k-hop queries, all
usable while mutations stream (snapshot isolation via the versioned store).

Every function computes on the view's device and returns tensors there
(host NumPy only where the reference returns NumPy: the timelines and
``emerging_vertices``). A WCC round on a CUDA view is the hand-written
``wcc_round`` kernel; the frontier and other min/max steps are plain
``scatter_reduce_``; iteration loops that the reference runs as
``lax.while_loop`` are Python loops that test their condition on the host
each round. Dtypes follow the reference with 64-bit types off: int32 ids
and labels, float32 values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.versioned import Version
from repro_torch.device import to_host
from repro_torch.graph.dyngraph import DynamicGraph, JoinView
from repro_torch.kernels import ops

_REDUCE = {"sum": "sum", "max": "amax", "min": "amin"}


def _identity(reduce: str, dtype: torch.dtype):
    """Value an empty segment holds after ``scatter_reduce_`` — what
    ``jax.ops.segment_{max,min}`` give an empty segment (the dtype's lowest
    / highest value, -inf / inf for floats)."""
    if reduce == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if reduce == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "max" else info.max


def _segment_reduce(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    reduce: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,max,min}`` over axis 0 with ids in
    [0, num_segments) (the callers never pass others)."""
    out = torch.full((num_segments, *data.shape[1:]),
                     _identity(reduce, data.dtype), dtype=data.dtype,
                     device=data.device)
    index = ids.long()
    if data.dim() > 1:
        index = index.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, index, data, _REDUCE[reduce],
                               include_self=True)


def _as_ids(x, device: torch.device) -> torch.Tensor:
    """Query ids (tensor, array or list) as a flat int32 tensor on
    ``device``."""
    return torch.as_tensor(x, device=device).reshape(-1).to(torch.int32)


# ----------------------------------------------------------- join-group-by
def join_group_by(view: JoinView, values: torch.Tensor, *,
                  reduce: str = "sum",
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """For every vertex d: reduce_{(s,d) in E} values[s].

    values: (n,) or (n, F). Returns same feature shape grouped by dst. A
    sum on a CUDA view goes through the ``segment_sum`` kernel (float32
    out, like the reference's kernel path); otherwise the plain scatter,
    which keeps the values' dtype like the reference's XLA path.
    """
    gathered = values[view.src]
    if reduce == "sum" and ops.wants_kernel(values, use_kernel):
        if values.dim() == 1:
            # CSR rows are dst-sorted, so the sorted segment sum applies
            # directly; lift to (m, 1)
            return ops.segment_sum(gathered[:, None].contiguous(), view.dst,
                                   view.n, use_kernel=True)[:, 0]
        return ops.segment_sum(gathered.contiguous(), view.dst, view.n,
                               use_kernel=True)
    if reduce not in _REDUCE:
        raise ValueError(reduce)
    return _segment_reduce(gathered, view.dst, view.n, reduce)


# ------------------------------------------------------------------ PageRank
@dataclasses.dataclass
class PageRankResult:
    ranks: torch.Tensor
    iterations: int
    residual: float


def pagerank(view: JoinView, *, damping: float = 0.85, tol: float = 1e-6,
             max_iter: int = 100, init: Optional[torch.Tensor] = None,
             handle_dangling: bool = True,
             use_kernel: Optional[bool] = None) -> PageRankResult:
    """Offline PageRank on one snapshot; supports warm start (``init``).
    ``handle_dangling`` redistributes sink mass uniformly (sum(pr)==1).
    float32 throughout; the residual (L1, float32) is read on the host
    after every iteration, as the reference's ``while_loop`` tests it."""
    n = view.n
    with trace.span("Compute.pagerank", m=view.m, n=n,
                    warm=init is not None) as sp:
        device = view.out_degree.device
        out_deg = torch.clamp(view.out_degree, min=1.0)
        dangling = view.out_degree == 0
        if init is None:
            pr = torch.full((n,), 1.0 / n, dtype=torch.float32,
                            device=device)
        else:
            pr = torch.as_tensor(init, device=device)
        resid, it = float("inf"), 0
        while resid > tol and it < max_iter:
            with trace.span("Compute.pagerank.iter") as step:
                contrib = pr / out_deg
                agg = join_group_by(view, contrib, use_kernel=use_kernel)
                if handle_dangling:
                    # dangling-mass redistribution keeps sum(pr) == 1
                    dmass = torch.where(dangling, pr, 0.0).sum()
                    agg = agg + dmass / n
                new = (1.0 - damping) / n + damping * agg
                resid = step.timed("wait_s", float, (new - pr).abs().sum())
            pr = new
            it += 1
        sp.set(iterations=it, residual=resid)
    return PageRankResult(pr, it, resid)


def incremental_pagerank(old: PageRankResult, old_view: JoinView,
                         new_view: JoinView, **kw) -> PageRankResult:
    """Online path: warm-start from the previous snapshot's ranks. The
    changed region re-converges locally; unchanged regions are already at
    their fixed point, so iterations drop sharply vs cold start."""
    return pagerank(new_view, init=old.ranks, **kw)


# ---------------------------------------------------------------------- SSSP
@dataclasses.dataclass
class SSSPResult:
    dist: torch.Tensor
    rounds: int
    relaxations: int


def sssp(view: JoinView, source: int, *,
         weights: Optional[torch.Tensor] = None,
         priority_fraction: float = 0.0,
         max_rounds: int = 10_000) -> SSSPResult:
    """Label-correcting SSSP over in-edges (dst pulls from src).

    ``priority_fraction > 0`` enables the paper's application-specific
    scheduling: only frontier vertices whose tentative distance is within the
    smallest ``priority_fraction`` quantile relax their out-edges each round
    (a vectorized Dijkstra/delta-stepping hybrid). Fewer total relaxations at
    the cost of more rounds — exactly the trade the input scheduler exposes.
    """
    n = view.n
    device = view.src.device
    w = (torch.as_tensor(weights, device=device) if weights is not None
         else torch.ones(view.m, dtype=torch.float32, device=device))
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    dist[source] = 0.0
    frontier = torch.zeros(n, dtype=torch.bool, device=device)
    frontier[source] = True
    src_ids = view.src.long()
    rounds = relax = 0
    while rounds < max_rounds and bool(frontier.any()):
        if priority_fraction > 0.0:
            fd = torch.where(frontier, dist, inf)
            # float32 product truncated to int32, as the reference computes k
            k = max(1, int((frontier.sum().to(torch.float32)
                            * priority_fraction).to(torch.int32)))
            kth = torch.sort(fd).values[min(k - 1, n - 1)]
            active = frontier & (dist <= kth)
        else:
            active = frontier
        # relax in-edges whose src is active
        src_d = dist[src_ids]
        src_act = active[src_ids]
        cand = torch.where(src_act, src_d + w, inf)
        best = _segment_reduce(cand, view.dst, n, "min")
        improved = best < dist
        dist = torch.where(improved, best, dist)
        frontier = (frontier & ~active) | improved
        rounds += 1
        relax += int(src_act.sum())
    return SSSPResult(dist, rounds, relax)


# ----------------------------------------------------------------------- WCC
def wcc(view: JoinView, max_rounds: int = 1000, *,
        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Weakly-connected components by min-label propagation (both
    directions), synchronous rounds until no label falls or ``max_rounds``.
    Returns (n,) int32 labels. On a CUDA view a round is one pass of the
    ``wcc_round`` kernel over the edges, ping-ponging two label buffers;
    on the CPU it is two scatter-mins (``use_kernel`` overrides; see
    :mod:`repro_torch.kernels.ops`). Both give the same labels after every
    round."""
    n = view.n
    kernel = ops.wants_kernel(view.src, use_kernel)
    with trace.span("Compute.wcc", m=view.m, n=n,
                    route="kernel" if kernel else "plain") as sp:
        if kernel:
            labels, it = _wcc_kernel_rounds(view, max_rounds)
            sp.set(rounds=it)
            return labels
        src_ids, dst_ids = view.src.long(), view.dst.long()
        labels = torch.arange(n, dtype=torch.int32, device=view.src.device)
        changed, it = True, 0
        while changed and it < max_rounds:
            with trace.span("Compute.wcc.round") as step:
                fwd = _segment_reduce(labels[src_ids], view.dst, n, "min")
                bwd = _segment_reduce(labels[dst_ids], view.src, n, "min")
                new = torch.minimum(labels, torch.minimum(fwd, bwd))
                changed = step.timed("wait_s", bool, (new != labels).any())
            labels = new
            it += 1
        sp.set(rounds=it)
    return labels


def _wcc_kernel_rounds(view: JoinView,
                       max_rounds: int) -> tuple[torch.Tensor, int]:
    """``wcc``'s rounds on the kernel route: (labels, rounds)."""
    labels = torch.arange(view.n, dtype=torch.int32, device=view.src.device)
    spare = torch.empty_like(labels)
    flag = torch.empty(1, dtype=torch.int32, device=labels.device)
    changed, it = True, 0
    while changed and it < max_rounds:
        with trace.span("Compute.wcc.round") as step:
            ops.wcc_round(view.src, view.dst, labels, out=spare,
                          changed=flag, use_kernel=True)
            changed = step.timed("wait_s", bool, flag)
        labels, spare = spare, labels
        it += 1
    return labels, it


# ------------------------------------------------------------ online queries
def _hop(reach: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
         segments: int) -> torch.Tensor:
    """One frontier step: dst reachable if any in-neighbor src reachable
    (``segment_max`` of the int32-cast gather, > 0)."""
    return _segment_reduce(reach[src].to(torch.int32), dst, segments,
                           "max") > 0


def k_hop(view: JoinView, sources, k: int) -> torch.Tensor:
    """Vertices reachable within k hops (out-direction) — online low-latency
    query; runs on a snapshot while mutations stream. Returns (n,) bool."""
    n = view.n
    device = view.src.device
    reach = torch.zeros(n, dtype=torch.bool, device=device)
    reach[_as_ids(sources, device).long()] = True
    src_ids = view.src.long()
    for _ in range(k):
        reach = reach | _hop(reach, src_ids, view.dst, n)
    return reach


def reachability(view: JoinView, src: int, dst: int,
                 max_hops: Optional[int] = None) -> bool:
    n = view.n
    max_hops = max_hops or n
    reach = torch.zeros(n, dtype=torch.bool, device=view.src.device)
    reach[src] = True
    src_ids = view.src.long()
    for _ in range(max_hops):
        new = reach | _hop(reach, src_ids, view.dst, n)
        if bool((new == reach).all()) or bool(new[dst]):
            reach = new
            break
        reach = new
    return bool(reach[dst])


# --------------------------------------------------- batched online queries
# Serving entry points: one call answers a whole window of same-kind
# queries. Query sources are padded to a power-of-two width and the
# snapshot's edge list to a power-of-two length (padding rows target a
# phantom segment ``n`` that is sliced off), the reference's bucketing:
# answers do not depend on it, and it keeps shapes to a few stable buckets.

def pad_pow2(size: int, floor: int = 1) -> int:
    """Next power of two >= size (>= floor) — the padding rule the serving
    layer uses to keep batched-query shapes stable."""
    return max(floor, 1 << max(0, int(size - 1).bit_length()))


def _padded_edges(view, pad_edges: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) with the edge list padded to a pow2 length; padded rows
    gather vertex 0 (harmless) and scatter into phantom segment ``n``
    (sliced off)."""
    m = view.m
    if not pad_edges or pad_pow2(m) == m:
        return view.src, view.dst
    width = pad_pow2(m)
    src = torch.zeros(width, dtype=view.src.dtype, device=view.src.device)
    src[:m] = view.src
    dst = torch.full((width,), view.n, dtype=view.dst.dtype,
                     device=view.dst.device)
    dst[:m] = view.dst
    return src, dst


def _reach0(n: int, sources: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) bool with column i set at its (padded) source."""
    padded = torch.zeros(width, dtype=torch.long, device=sources.device)
    padded[:sources.numel()] = sources
    reach = torch.zeros((n, width), dtype=torch.bool, device=sources.device)
    reach[padded, torch.arange(width, device=sources.device)] = True
    return reach


def batched_k_hop(view, sources, k: int, *, pad_sources: bool = True,
                  pad_edges: bool = True) -> torch.Tensor:
    """Per-source k-hop reachability for a whole query window at once.

    Unlike :func:`k_hop` (which unions its sources into ONE frontier), this
    answers S independent queries in a single vectorized sweep: returns
    (S, n) bool, row i = vertices within k out-hops of ``sources[i]``.
    Row i equals ``k_hop(view, sources[i:i+1], k)`` bit for bit.
    """
    device = view.src.device
    sources = _as_ids(sources, device)
    s = int(sources.numel())
    if s == 0:
        return torch.zeros((0, view.n), dtype=torch.bool, device=device)
    width = pad_pow2(s) if pad_sources else s
    reach = _reach0(view.n, sources, width)
    src, dst = _padded_edges(view, pad_edges)
    src_ids = src.long()
    for _ in range(int(k)):
        # n + 1 segments: the phantom segment swallows padded edges
        reach = reach | _hop(reach, src_ids, dst, view.n + 1)[:view.n]
    return reach.T[:s].contiguous()


def batched_reachability(view, src_ids, dst_ids,
                         max_hops: Optional[int] = None, *,
                         pad_sources: bool = True,
                         pad_edges: bool = True) -> torch.Tensor:
    """Multi-source frontier reachability: answers S (src -> dst) queries in
    one frontier sweep — the batched counterpart of :func:`reachability`.
    Returns (S,) bool. The shared frontier stops early once every target is
    found or no per-source frontier changed."""
    device = view.src.device
    src_ids = _as_ids(src_ids, device)
    dst_ids = _as_ids(dst_ids, device)
    if src_ids.shape != dst_ids.shape:
        raise ValueError("src_ids and dst_ids must have the same length")
    s = int(src_ids.numel())
    if s == 0:
        return torch.zeros((0,), dtype=torch.bool, device=device)
    width = pad_pow2(s) if pad_sources else s
    targets = torch.zeros(width, dtype=torch.long, device=device)
    targets[:s] = dst_ids
    cols = torch.arange(width, device=device)
    reach = _reach0(view.n, src_ids, width)
    # falsy max_hops (None or 0) means unbounded — same promotion the
    # scalar reachability() applies, so the two entry points agree
    hops = max_hops or view.n
    src, dst = _padded_edges(view, pad_edges)
    src_ids64 = src.long()
    changed, it = True, 0
    while changed and it < hops and not bool(reach[targets, cols].all()):
        new = reach | _hop(reach, src_ids64, dst, view.n + 1)[:view.n]
        changed = bool((new != reach).any())
        reach = new
        it += 1
    return reach[targets, cols][:s]


def degree_topk(view: JoinView, k: int, *,
                direction: str = "in") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k vertices by in/out-degree on one snapshot — (ids int32,
    degrees float32), degrees descending, ties by lowest vertex id (a
    stable descending sort, the order ``lax.top_k`` gives). ``k`` larger
    than n returns all n vertices."""
    if direction not in ("in", "out"):
        raise ValueError(direction)
    deg = view.in_degree if direction == "in" else view.out_degree
    k = min(int(k), view.n)
    vals, ids = torch.sort(deg, descending=True, stable=True)
    return ids[:k].to(torch.int32), vals[:k]


# --------------------------------------------------------- temporal analytics
def degree_timeline(g: DynamicGraph, versions: list[Version],
                    use_kernel: Optional[bool] = None) -> np.ndarray:
    """(T, n) in-degree per snapshot — 'who makes the most friends this
    month?' is an argmax over a diff of this."""
    out = []
    for v in versions:
        view = g.join_view(v, use_kernel=use_kernel)
        out.append(to_host(view.in_degree))
    return np.stack(out)


def pagerank_timeline(g: DynamicGraph, versions: list[Version],
                      incremental: bool = True,
                      use_kernel: Optional[bool] = None,
                      **kw) -> list[PageRankResult]:
    """PageRank over an evolving sequence of snapshots; incremental mode
    warm-starts each epoch from the previous one (paper stage-4 temporal
    mining). ``use_kernel`` applies to both the snapshot masks and the
    segment sums."""
    results: list[PageRankResult] = []
    prev: Optional[PageRankResult] = None
    prev_view: Optional[JoinView] = None
    for v in versions:
        view = g.join_view(v, use_kernel=use_kernel)
        if incremental and prev is not None:
            res = incremental_pagerank(prev, prev_view, view,
                                       use_kernel=use_kernel, **kw)
        else:
            res = pagerank(view, use_kernel=use_kernel, **kw)
        results.append(res)
        prev, prev_view = res, view
    return results


def emerging_vertices(g: DynamicGraph, v_old: Version, v_new: Version,
                      top_k: int = 10) -> np.ndarray:
    """Temporal pattern: vertices with the largest in-degree growth between
    two snapshots ('who made the most friends this month?')."""
    d_old = to_host(g.join_view(v_old).in_degree)
    d_new = to_host(g.join_view(v_new).in_degree)
    growth = d_new - d_old
    return np.argsort(-growth)[:top_k]
