"""Plain PyTorch reference of the graph cells' semantics.

Independent of the program: it imports nothing of ``repro_torch`` (nor
JAX), and works from the edge multiset that the harness's own stream
gives at a version (``stream.Layout.live_blocks``), never from the
program's store, views or ranks. A store holds a multiset of directed
edges; a deletion removes one copy of its (src, dst) pair. So the live
multiset once epoch ``e`` is sealed is the union of the live blocks.

The answers follow the query semantics the program documents: a k-hop
answer is the set of vertices within ``k`` out-hops of the source, the
source included; reachability is whether ``dst`` lies within
``max_hops`` out-hops of ``src``; the in-degree top-k is the ``k``
largest in-degrees, ties by lowest id; PageRank is the damped power
iteration with the dangling mass spread uniformly, and WCC labels each
vertex with the lowest id of its weakly connected component.
"""
from __future__ import annotations

import torch

_M1 = 0x1CE4E5B9BF58476D     # odd, below 2**63: a signed 64-bit constant
_M2 = 0x133111EB94D049BB


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit mixing step on int64 tensors (wrapping arithmetic, logical
    shifts by masking the arithmetic ones)."""
    x = x ^ ((x >> 31) & ((1 << 33) - 1))
    x = x * _M1
    x = x ^ ((x >> 29) & ((1 << 35) - 1))
    x = x * _M2
    return x ^ ((x >> 32) & ((1 << 32) - 1))


def tensor_digest(x: torch.Tensor) -> torch.Tensor:
    """Order-sensitive digest of an integer tensor (0-d int64, on its
    device): the wrapped sum of a mix of each value with its position."""
    x = x.reshape(-1).to(torch.int64)
    pos = torch.arange(x.numel(), device=x.device, dtype=torch.int64)
    return _mix(_mix(pos + 0x5851F42D) ^ x).sum()


def view_digest_tensor(offsets, src, dst, out_degree,
                       in_degree) -> torch.Tensor:
    """Digest of one CSR snapshot as a (5,) int64 tensor on its device,
    computed without waiting for the device: edge count, rows in (dst,
    src) order, offsets, out- and in-degrees. The program's views and the
    reference's rows go through this one function."""
    keys = (dst.to(torch.int64) << 32) | src.to(torch.int64)
    count = torch.tensor(keys.numel(), dtype=torch.int64, device=keys.device)
    return torch.stack([count, tensor_digest(keys), tensor_digest(offsets),
                        tensor_digest(out_degree.to(torch.int64)),
                        tensor_digest(in_degree.to(torch.int64))])


class RefGraph:
    """The live multiset at one version, on ``src.device``: canonical rows
    sorted by (dst, src), degrees and CSR offsets."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        self.n = n
        keys = (dst.to(torch.int64) << 32) | src.to(torch.int64)
        keys = torch.sort(keys).values
        self.dst = (keys >> 32).to(torch.int64)
        self.src = (keys & 0xFFFFFFFF).to(torch.int64)
        self.in_deg = torch.bincount(self.dst, minlength=n)
        self.out_deg = torch.bincount(self.src, minlength=n)
        self.offsets = torch.zeros(n + 1, dtype=torch.int64,
                                   device=src.device)
        self.offsets[1:] = torch.cumsum(self.in_deg, 0)

    @property
    def m(self) -> int:
        return int(self.src.numel())

    def digest(self) -> list[int]:
        return view_digest_tensor(self.offsets, self.src, self.dst,
                                  self.out_deg, self.in_deg).tolist()

    def _step(self, reach: torch.Tensor) -> torch.Tensor:
        new = reach.clone()
        new[self.dst[reach[self.src]]] = True
        return new

    def k_hop(self, source: int, k: int) -> torch.Tensor:
        reach = torch.zeros(self.n, dtype=torch.bool, device=self.src.device)
        reach[source] = True
        for _ in range(k):
            reach = self._step(reach)
        return reach

    def reachable(self, s: int, d: int, max_hops: int) -> bool:
        reach = torch.zeros(self.n, dtype=torch.bool, device=self.src.device)
        reach[s] = True
        for _ in range(max_hops):
            if bool(reach[d]):
                break
            new = self._step(reach)
            if torch.equal(new, reach):
                break
            reach = new
        return bool(reach[d])

    def degree_topk(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        vals, ids = torch.sort(self.in_deg, descending=True, stable=True)
        return ids[:k], vals[:k]

    def pagerank(self, *, damping: float = 0.85, tol: float = 1e-14,
                 max_iter: int = 1000, dtype=torch.float64,
                 init=None) -> tuple[torch.Tensor, int]:
        """Power iteration in ``dtype`` until the L1 change is below
        ``tol`` (or ``max_iter``): (ranks, iterations)."""
        n, dev = self.n, self.src.device
        out = torch.clamp(self.out_deg, min=1).to(dtype)
        dangling = self.out_deg == 0
        pr = (torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
              if init is None else init.to(dtype))
        it = 0
        while it < max_iter:
            contrib = (pr / out)[self.src]
            agg = torch.zeros(n, dtype=dtype, device=dev)
            agg.index_add_(0, self.dst, contrib)
            dmass = pr[dangling].sum()
            new = (1.0 - damping) / n + damping * (agg + dmass / n)
            resid = float((new.double() - pr.double()).abs().sum())
            pr = new
            it += 1
            if resid <= tol:
                break
        return pr, it

    def wcc(self) -> torch.Tensor:
        """Lowest vertex id of each vertex's weakly connected component:
        min-label hooking over both edge directions with pointer jumping
        until nothing changes."""
        labels = torch.arange(self.n, dtype=torch.int64,
                              device=self.src.device)
        while True:
            new = labels.clone()
            new.scatter_reduce_(0, self.dst, labels[self.src], "amin")
            new.scatter_reduce_(0, self.src, labels[self.dst], "amin")
            while True:
                jumped = new[new]
                if torch.equal(jumped, new):
                    break
                new = jumped
            if torch.equal(new, labels):
                return labels
            labels = new


def live_graph(stream, layout, epoch: int) -> RefGraph:
    """The reference graph once store epoch ``epoch`` is sealed."""
    src, dst = stream.blocks(layout.live_blocks(epoch))
    return RefGraph(src, dst, stream.n)
