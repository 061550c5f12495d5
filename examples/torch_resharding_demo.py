"""Adaptive re-sharding walkthrough on the PyTorch port: a hot shard
splits itself.

A zipf-skewed mutation stream (a few hot destination vertices take most
of the edges) is served by the port's ``GraphQueryServer`` whose
``ShardedDynamicGraph`` carries a ``ShardPlanner`` and lives on
``--device``. The access ledger (mutation routing counts and query
touches) trips the planner, the hot shard's key range is split at a seal
boundary, and the migrating half-range rides as ordinary mutation
payloads, while every answer stays byte-identical to a single-store
replay on the CPU, audited at the end.

    PYTHONPATH=src python examples/torch_resharding_demo.py [--smoke]

``--smoke`` runs the sizes of the JAX package's demo at ``--smoke``.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain path on the host.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.replica import ShardPlanner
from repro_torch.core.versioned import Version
from repro_torch.device import to_host
from repro_torch.graph import compute as gc
from repro_torch.graph.dyngraph import DynamicGraph, synthesize_skewed_stream
from repro_torch.graph.query import KHop, PageRankQuery
from repro_torch.graph.sharded import ShardedDynamicGraph
from repro_torch.launch.serve_graph import GraphQueryServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny config for CI")
    ap.add_argument("--device", default="cuda",
                    help="device of the store, its views and kernels")
    args = ap.parse_args()
    n = 400 if args.smoke else 4_000
    epochs = 6 if args.smoke else 10
    adds = 400 if args.smoke else 4_000

    batches = synthesize_skewed_stream(n, epochs, adds, seed=0,
                                       zipf_a=1.2, delete_frac=0.1)
    e_max = sum(len(b.add_src) for b in batches) + 16
    planner = ShardPlanner(imbalance_threshold=1.2, min_load=adds / 4.0,
                           min_epochs=1, max_shards=8)
    sg = ShardedDynamicGraph(4, n, e_max, planner=planner,
                             device=args.device)
    server = GraphQueryServer(sg, tol=1e-6, max_iter=200)

    print(f"== zipf-skewed stream ({epochs} epochs x {adds} adds) into "
          f"4 shards + ShardPlanner on {sg.device} ==")
    rng = np.random.default_rng(1)
    answered = []
    t0 = time.perf_counter()
    for b in batches:
        n_events = len(server.reshard_events)
        server.step(b)                 # planner tick + ingest + seal
        for _ in range(4):
            server.submit(KHop(int(rng.integers(0, n)), k=2))
        server.submit(PageRankQuery(top_k=5))
        answered.extend(server.flush())
        # live edges per shard at the served snapshot (edge ROWS would
        # still count the migration-tombstoned rows on the source shard)
        counts = [v.m for v in sg.shard_views(b.version)]
        marker = ""
        if len(server.reshard_events) > n_events:
            ev = server.reshard_events[-1]
            marker = (f"   <- SPLIT shard {ev['source']} -> {ev['target']} "
                      f"(plan {ev['plan_id']}, {ev['migrated_edges']} edges "
                      f"migrated inside epoch "
                      f"{ev['activation_epoch']}'s seal)")
        share = max(counts) / max(sum(counts), 1)
        print(f"  epoch {b.version.epoch}: live edges/shard {counts} "
              f"(hottest holds {share:.0%}){marker}")
    wall = time.perf_counter() - t0

    s = server.stats()
    server.stop_prewarm()
    print(f"\n{len(server.reshard_events)} splits fired; "
          f"{s.n_shards} shards under routing plan "
          f"{s.routing_plan_id}; served {s.served} queries "
          f"in {wall:.2f}s")

    # audit: replay on a single store on the CPU; every k-hop answer and
    # the final stitched view must be byte-identical despite the migrations
    g = DynamicGraph(n, e_max, device="cpu")
    for b in batches:
        g.apply(b)
    checked = 0
    for r in answered:
        if isinstance(r.query, KHop):
            expect = to_host(gc.k_hop(g.join_view(r.version),
                                      np.array([r.query.source]),
                                      r.query.k))
            got = to_host(r.value)
            if got.dtype != expect.dtype or not np.array_equal(got, expect):
                raise RuntimeError(f"divergence at {r.version} for {r.query}")
            checked += 1
    v_last = Version(epochs - 1, 0)
    sv, gv = sg.join_view(v_last), g.join_view(v_last)
    for f in ("offsets", "src", "dst", "out_degree", "in_degree"):
        if not np.array_equal(to_host(getattr(sv, f)),
                              to_host(getattr(gv, f))):
            raise RuntimeError(f"final stitched view: {f} diverged")
    if not server.reshard_events:
        raise SystemExit("expected at least one split on the skewed stream")
    print(f"{checked} k-hop answers + final stitched CSR audited "
          "byte-identical against a single-store replay on the CPU")
    print("\nOK — hot shard split itself; queries never noticed")


if __name__ == "__main__":
    main()
