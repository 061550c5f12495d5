"""END-TO-END DEMO on the PyTorch port: the paper's system doing the
paper's job, with the store, its views and the kernels on ``--device``.

A dynamic citation-style graph evolves through a stream of mutation epochs:

  1. schema evolution (§2.1): Author/Paper schema grows a new version +
     School nodes mid-stream;
  2. asynchronous ingestion (§2.3.1): ingest nodes dispatch mutations with
     the no-wait rule; the global snapshot frontier trails local frontiers;
  3. ONLINE computing: k-hop neighborhood + reachability queries answered
     on sealed snapshots while newer epochs are still ingesting;
  4. OFFLINE analytics: PageRank timeline (incremental, warm-started — the
     online/offline shared-data goal), WCC, emerging-vertex detection
     ("who made the most friends this month?");
  5. replica-coherence management (§2.2): hub-mirror placement from access
     stats, hit-rate before/after rebalancing;
  6. distributed views: the analytics table is a lineage-tracked view;
     we simulate a node failure and recover it by lineage replay, which
     recomputes the ranks on the same device.

    PYTHONPATH=src python examples/torch_dynamic_graph_end_to_end.py

The sizes are the JAX package's demo (256 vertices, 8 epochs of 300
adds, 4 shards). ``--device`` defaults to ``cuda`` and raises without a
card; ``--device cpu`` runs the plain path on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.replica import ReplicaManager
from repro_torch.core.versioned import Version
from repro_torch.core.views import View
from repro_torch.device import resolve_device, to_host
from repro_torch.graph import compute as gc
from repro_torch.graph.dyngraph import synthesize_stream
from repro_torch.graph.partition import (comm_model, partition_graph,
                                         partition_graph_sharded)
from repro_torch.graph.schema import citation_schema
from repro_torch.graph.sharded import ShardedDynamicGraph

VIEW_FIELDS = ("offsets", "src", "dst", "out_degree", "in_degree")


@dataclasses.dataclass(frozen=True)
class Size:
    """The stream of one run; the defaults are the JAX demo's."""
    vertices: int = 256
    epochs: int = 8
    adds: int = 300
    shards: int = 4
    seed: int = 42


def same_view(got, want) -> bool:
    """Every array of two join views equal in dtype, shape and bytes."""
    for f in VIEW_FIELDS:
        a, b = to_host(getattr(got, f)), to_host(getattr(want, f))
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            return False
    return True


def run_demo(size: Size, device) -> dict:
    """The whole walkthrough on ``device``; returns its facts (raises if
    the stitched view differs from the single store's, or the recovered
    table from the first)."""
    resolve_device(device)
    n, epochs, adds = size.vertices, size.epochs, size.adds
    out: dict = {"device": str(device)}

    # 1) schema evolution
    reg = citation_schema()
    out["author_versions"] = reg.versions_of("Author")
    out["author2_fields"] = reg.fields_of("Author", 2)

    # 2) async sharded ingestion
    g, batches = synthesize_stream(n, epochs, adds, seed=size.seed,
                                   device=device)
    sg = ShardedDynamicGraph(size.shards, n, epochs * adds * 2 + 16,
                             device=device)
    for e, batch in enumerate(batches):
        sg.ingest(batch)              # no-wait dispatch to the shards
        if e == 0:                    # straggler: shard 0 seals late
            for shard in range(1, size.shards):
                sg.seal_shard(shard, e)
            out["straggler_frontier"] = sg.coordinator.global_frontier
        sg.seal_epoch(e)              # every shard sealed -> frontier moves
    out["dispatched"] = sg.ingest_node.dispatched
    out["edges_per_shard"] = sg.shard_edge_counts()
    out["global_frontier"] = sg.coordinator.global_frontier
    v_last = Version(epochs - 1, 0)
    stitched = sg.join_view(v_last)
    if not same_view(stitched, g.join_view(v_last)):
        raise RuntimeError("the stitched join view differs from the "
                           "single store's")
    out["stitched_m"] = stitched.m

    # 3) online queries on sealed snapshots
    v_mid = Version(epochs // 2, 0)
    view_mid = g.join_view(v_mid)
    hubs = np.argsort(-to_host(view_mid.in_degree))[:3]
    out["hubs"] = [int(h) for h in hubs]
    reach = to_host(gc.k_hop(view_mid, np.array([int(hubs[0])]), 2))
    out["two_hop"] = int(reach.sum())
    out["reach"] = bool(gc.reachability(view_mid, int(hubs[0]),
                                        int(hubs[1])))

    # 4) offline analytics (timeline, warm-started)
    versions = [Version(e, 0) for e in range(epochs)]
    cold = gc.pagerank(g.join_view(v_last), tol=1e-8, max_iter=300)
    prs = gc.pagerank_timeline(g, versions, incremental=True, tol=1e-8,
                               max_iter=300)
    out["timeline_iterations"] = [p.iterations for p in prs]
    out["cold_iterations"] = cold.iterations
    out["emerging"] = gc.emerging_vertices(g, versions[-3], versions[-1],
                                           top_k=5).tolist()
    labels = to_host(gc.wcc(g.join_view(v_last)))
    out["components"] = len(set(labels.tolist()))

    # 5) replica-coherence management
    rm = ReplicaManager(4, mirror_threshold=4)
    deg = to_host(g.join_view(v_last).in_degree)
    for vid in range(n):
        rm.add_item(vid, owner=vid % 4, value=float(deg[vid]))
    rng = np.random.default_rng(0)
    popular = np.argsort(-deg)[:16]

    def workload():
        for _ in range(2000):
            item = int(popular[rng.integers(0, 16)])  # hot reads of hubs
            rm.read(int(rng.integers(0, 4)), item)
    workload()
    out["hit_rate_before"] = rm.stats()["hit_rate"]
    rm.rebalance()
    rm.local_hits = rm.remote_misses = 0
    workload()
    out["hit_rate_after"] = rm.stats()["hit_rate"]
    cm = comm_model(partition_graph(g.join_view(v_last), 8, hub_k=8))
    out["comm_bytes"] = {k: cm[k] for k in ("allgather", "scatter", "hub")}
    pgs = partition_graph_sharded(sg.shard_views(v_last), hub_k=8)
    out["sharded_parts"], out["sharded_placement"] = (pgs.n_parts,
                                                      pgs.placement)

    # 6) distributed views: failure + lineage recovery on the same device
    snap_view = View.source("graph@last", lambda: g.join_view(v_last))
    ranks = snap_view.map("pagerank", lambda v: gc.pagerank(v, tol=1e-8).ranks)
    table = ranks.map("top10", lambda r: np.argsort(-to_host(r))[:10])
    top10 = table.value()
    table.invalidate(recursive=True)
    recovered = table.recover()        # replay lineage
    if not np.array_equal(top10, recovered):
        raise RuntimeError("the recovered top-10 differs from the first")
    out["ranks_device"] = str(ranks.value().device)
    out["top10"] = top10.tolist()
    sg.shutdown()
    return out


def report(f: dict) -> list[str]:
    """The JAX demo's printed lines, from the facts of :func:`run_demo`."""
    hubs, cb = f["hubs"], f["comm_bytes"]
    return [
        "== schema (paper Fig 2) ==",
        f"  Author versions: {f['author_versions']} | Author<2> fields: "
        f"{f['author2_fields']}",
        "",
        "== sharded ingestion (dst-hash routing, no-wait dispatch) ==",
        f"  shard 0 lagging: global frontier = {f['straggler_frontier']} "
        "(snapshot 0 not yet queryable)",
        f"  dispatched={f['dispatched']} mutations, "
        f"edges/shard={f['edges_per_shard']}, "
        f"global frontier={f['global_frontier']}",
        f"  stitched join view == single-store view ({f['stitched_m']} "
        "edges)",
        "",
        "== online queries (snapshot isolation) ==",
        f"  2-hop neighborhood of hub {hubs[0]}: {f['two_hop']} vertices",
        f"  reach({hubs[0]} -> {hubs[1]}) @v_mid: {f['reach']}",
        "",
        "== offline analytics ==",
        f"  pagerank timeline: iters/epoch = {f['timeline_iterations']} "
        f"(cold last-epoch: {f['cold_iterations']})",
        f"  emerging vertices (most new in-links): {f['emerging']}",
        f"  WCC components @last: {f['components']}",
        "",
        "== replica-coherence (access-driven placement) ==",
        f"  hit-rate before/after rebalance: {f['hit_rate_before']:.2f} -> "
        f"{f['hit_rate_after']:.2f}",
        f"  comm bytes/superstep: allgather={cb['allgather']:.0f} "
        f"scatter={cb['scatter']:.0f} hub={cb['hub']:.0f}",
        f"  sharded fast path: {f['sharded_parts']} partitions consumed "
        f"pre-bucketed ({f['sharded_placement']}-placed, no re-bucketing "
        "pass)",
        "",
        "== distributed views (lineage fault tolerance) ==",
        f"  top-10 by pagerank: {f['top10']} "
        "(recovered identically after simulated failure)",
        "",
        "OK — end-to-end dynamic graph computing complete",
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the stores, their views and kernels")
    args = ap.parse_args()
    for line in report(run_demo(Size(), args.device)):
        print(line)


if __name__ == "__main__":
    main()
