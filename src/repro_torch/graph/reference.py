"""Loop-based reference implementation of the dynamic-graph store.

The per-element ingestion semantics, kept as an executable oracle:
``apply`` walks mutations one by one (deletes scan all live rows, O(E)
each) and ``join_view_arrays`` builds the CSR with explicit per-vertex
buckets. The vectorized ``DynamicGraph`` must produce the same CSRs
(offsets/src/dst/degrees) on the host, whatever device its views live on
— see ``tests/test_torch_reference.py``. Plain NumPy: nothing here
touches a device.

Rows are emitted in canonical (dst, src) order, matching
``DynamicGraph.join_view``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.versioned import (Version, pack32_checked, pack32_clamped)
from repro_torch.graph.dyngraph import MAXV, MutationBatch


class LoopDynamicGraph:
    """Seed-semantics store: per-element loops, O(E) delete scans.

    Stamps use the same int32 data-plane packing as the vectorized store
    (``MAXV`` = int32 max = 'never'), so equivalence tests can compare the
    stamp/vertex tables of the two stores byte-for-byte.
    """

    def __init__(self, n_max: int, e_max: int):
        self.n_max = n_max
        self.e_max = e_max
        self.src = np.zeros(e_max, np.int32)
        self.dst = np.zeros(e_max, np.int32)
        self.created = np.full(e_max, MAXV, np.int32)
        self.deleted = np.full(e_max, MAXV, np.int32)
        self.n_edges = 0
        self.v_created = np.full(n_max, MAXV, np.int32)
        self.v_type = np.zeros(n_max, np.int32)
        self.n_vertices = 0
        self.versions: list[Version] = []

    def apply(self, batch: MutationBatch) -> None:
        if self.versions \
                and batch.version.pack() <= self.versions[-1].pack():
            raise ValueError("mutation batches must have increasing versions")
        v = pack32_checked(batch.version)
        for vid, vt in zip(batch.add_vertices, batch.vertex_types, strict=True):
            if self.v_created[vid] == MAXV:
                self.v_created[vid] = v
                self.v_type[vid] = vt
                self.n_vertices += 1
        k = len(batch.add_src)
        if k:
            if self.n_edges + k > self.e_max:
                raise MemoryError("edge capacity exceeded")
            sl = slice(self.n_edges, self.n_edges + k)
            self.src[sl] = batch.add_src
            self.dst[sl] = batch.add_dst
            self.created[sl] = v
            self.deleted[sl] = MAXV
            for vid in np.concatenate([batch.add_src, batch.add_dst]):
                if self.v_created[vid] == MAXV:
                    self.v_created[vid] = v
                    self.n_vertices += 1
            self.n_edges += k
        for s, d in zip(batch.del_src, batch.del_dst, strict=True):
            live = np.flatnonzero(
                (self.src[:self.n_edges] == s) & (self.dst[:self.n_edges] == d)
                & (self.deleted[:self.n_edges] == MAXV))
            if live.size:
                self.deleted[live[-1]] = v
        self.versions.append(batch.version)

    def snapshot_mask(self, version: Version) -> np.ndarray:
        v = pack32_clamped(version)
        e = self.n_edges
        return (self.created[:e] <= v) & (v < self.deleted[:e])

    def join_view_arrays(self, version: Version):
        """CSR arrays (offsets, src, dst, out_deg, in_deg) via explicit
        per-destination buckets — the equivalence oracle."""
        mask = self.snapshot_mask(version)
        src = self.src[:self.n_edges][mask]
        dst = self.dst[:self.n_edges][mask]
        n = self.n_max
        buckets: list[list[int]] = [[] for _ in range(n)]
        out_deg = np.zeros(n, np.int64)
        for s, d in zip(src.tolist(), dst.tolist(), strict=True):
            buckets[d].append(s)
            out_deg[s] += 1
        offsets = np.zeros(n + 1, np.int64)
        src_rows: list[int] = []
        dst_rows: list[int] = []
        in_deg = np.zeros(n, np.int64)
        for d, bucket in enumerate(buckets):
            bucket.sort()
            src_rows.extend(bucket)
            dst_rows.extend([d] * len(bucket))
            in_deg[d] = len(bucket)
            offsets[d + 1] = offsets[d] + len(bucket)
        return (offsets, np.asarray(src_rows, np.int32),
                np.asarray(dst_rows, np.int32), out_deg, in_deg)
