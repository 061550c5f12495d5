"""INGEST-WHILE-QUERYING DEMO on the PyTorch port: the paper's integrated
online/offline claim, live, with the store and its kernels on
``--device``.

A background thread streams mutation epochs into a 4-shard
``ShardedDynamicGraph`` (no-wait dispatch, per-shard seals, global
frontier), and the server's prewarm thread ranks each newly published
snapshot. The foreground thread is a query client hammering the
``GraphQueryServer`` the whole time: every answered window is served
strictly from the newest frontier-sealed snapshot — a moving target while
the stream is live — and each k-hop, reachability and top-k answer is
checked byte-for-byte against a single-store replay on the CPU at the
SAME version after the fact.

    PYTHONPATH=src python examples/torch_serve_graph_live.py          # full
    PYTHONPATH=src python examples/torch_serve_graph_live.py --smoke  # CI

The sizes are the JAX package's demo's. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain path
on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graph.dyngraph import DynamicGraph, synthesize_churn_stream
from repro_torch.graph.query import (DegreeTopK, KHop, PageRankQuery,
                                     Reachability, SnapshotQueryEngine)
from repro_torch.graph.sharded import ShardedDynamicGraph
from repro_torch.launch.serve_graph import GraphQueryServer
from torch_crash_recovery_demo import same_answer


@dataclasses.dataclass(frozen=True)
class LiveRun:
    """One run; the defaults are the JAX demo's full size, :data:`SMOKE`
    its ``--smoke`` size."""
    vertices: int = 2_000
    epochs: int = 10
    adds: int = 800
    shards: int = 4
    seed: int = 1
    client_seed: int = 7
    delay_s: float = 0.8       # pause after each epoch's seal


SMOKE = LiveRun(vertices=300, epochs=6, adds=150)


def audit(n: int, batches, answers) -> dict:
    """Replay ``batches`` on a single store of ``n`` vertices on the CPU
    and hold every k-hop, reachability and top-k answer of ``answers``
    ((query, version, value) triples) to the store's answer at the
    version it was served from; returns the counts audited by kind."""
    e_max = sum(len(b.add_src) for b in batches) + 16
    g = DynamicGraph(n, e_max, device="cpu")
    for b in batches:
        g.apply(b)
    engine = SnapshotQueryEngine(result_cache=False, use_kernel=False)
    by_version: dict = {}
    for q, version, value in answers:
        if not isinstance(q, PageRankQuery):
            by_version.setdefault(version, []).append((q, value))
    checked: dict = {}
    for version, qvs in sorted(by_version.items()):
        want = engine.execute(g.join_view(version), [q for q, _ in qvs])
        for (q, value), w in zip(qvs, want):
            if not same_answer(q, value, w):
                raise RuntimeError(f"divergence at {version} for {q}")
            kind = type(q).__name__
            checked[kind] = checked.get(kind, 0) + 1
    return checked


def run_demo(run: LiveRun, device, log=None) -> dict:
    """Stream, serve and audit on ``device``; ``log`` (when given) gets
    a progress line every 5 windows. Returns the facts, the answers among
    them."""
    resolve_device(device)
    n = run.vertices
    batches = synthesize_churn_stream(n, run.epochs, run.adds,
                                      seed=run.seed, delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    sg = ShardedDynamicGraph(run.shards, n, e_max, device=device)
    server = GraphQueryServer(sg, prewarm_pagerank=True, tol=1e-4,
                              max_iter=200)
    t0 = time.perf_counter()
    # pace the stream so epochs keep sealing while the client queries
    thread = server.start_background_ingest(iter(batches),
                                            delay_s=run.delay_s)
    rng = np.random.default_rng(run.client_seed)
    answered = []
    windows = 0
    try:
        while thread.is_alive() or not answered:
            for _ in range(4):
                server.submit(KHop(int(rng.integers(0, n)), k=2))
            server.submit(Reachability(int(rng.integers(0, n)),
                                       int(rng.integers(0, n)), max_hops=6))
            server.submit(DegreeTopK(5))
            server.submit(PageRankQuery(top_k=5))
            try:
                results = server.flush()
            except RuntimeError:          # nothing globally sealed yet
                time.sleep(0.005)
                continue
            answered.extend(results)
            windows += 1
            if log is not None and windows % 5 == 1:
                p95 = np.percentile([r.latency_s for r in answered], 95)
                log(f"  window {windows}: {len(results)} queries @ snapshot"
                    f" epoch {results[0].version.epoch} (p95 so far "
                    f"{p95 * 1e3:.1f} ms)")
        thread.join()
        wall_s = time.perf_counter() - t0
        s = server.stats()
    finally:
        server.stop_prewarm()
        sg.shutdown()
    t = time.perf_counter()
    checked = audit(n, batches,
                    [(r.query, r.version, r.value) for r in answered])
    return {"served": s.served, "windows": windows, "wall_s": wall_s,
            "audited": checked, "audit_s": time.perf_counter() - t,
            "versions": len({r.version for r in answered}),
            "final_epoch": max(r.version.epoch for r in answered),
            "p50_ms": s.query_p50_s * 1e3, "p95_ms": s.query_p95_s * 1e3,
            "vectorized_calls": dict(s.vectorized_calls),
            "rank_warm_starts": s.rank_warm_starts,
            "rank_cold_starts": s.rank_cold_starts,
            "rank_cache_hits": s.rank_cache_hits,
            "prewarm_runs": s.prewarm_runs,
            "cached_stitched_views": s.cached_stitched_views,
            "cached_rank_versions": s.cached_rank_versions,
            "answered": answered}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config for CI")
    ap.add_argument("--device", default="cuda",
                    help="device of the store, its views and kernels")
    args = ap.parse_args()
    run = SMOKE if args.smoke else LiveRun()
    print(f"== streaming {run.epochs} epochs into {run.shards} shards while "
          "querying ==")
    f = run_demo(run, args.device, log=print)
    audited = ", ".join(f"{v} {k}" for k, v in sorted(f["audited"].items()))
    print(f"\nserved {f['served']} queries in {f['windows']} windows while "
          f"ingesting; {audited} answers audited byte-identical against "
          "the single store on the CPU")
    print(f"  p50={f['p50_ms']:.2f}ms  p95={f['p95_ms']:.2f}ms")
    print(f"  vectorized calls: {f['vectorized_calls']}")
    print(f"  pagerank: {f['rank_warm_starts']} warm starts / "
          f"{f['rank_cold_starts']} cold, {f['rank_cache_hits']} cache hits,"
          f" {f['prewarm_runs']} prewarms")
    print(f"  bounded caches: {f['cached_stitched_views']} stitched views, "
          f"{f['cached_rank_versions']} rank versions")
    print("\nOK — online queries served on live sharded snapshots")


if __name__ == "__main__":
    main()
