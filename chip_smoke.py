#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero
before the result lines:

1. Device line (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``src/repro_torch/csrc``.
2. Every kernel against its plain PyTorch version on the card, at the
   serving slice's shapes: ``liveness_mask`` (16,000,000 stamps, sentinel
   and clamped query included) and ``snapshot_resolve`` (4,000,000 x 4),
   byte-equal; ``segment_sum`` at 1,000,000 x 16 bf16 (3e-2 relative).
   Times are CUDA-event medians of 20 runs after warm-up.
3. The serving slice, driven as ``python -m repro_torch.launch.serve_graph``
   drives it: 1,048,576 vertices in 4 shards on the card, a 16-epoch churn
   stream of 1,000,000 adds per epoch with ``delete_frac=0.2`` (seed 0), 16
   demo queries per epoch through ``GraphQueryServer``, PageRank prewarmed
   every epoch (tol 1e-6, max_iter 200). Launch counts are reset just
   before and read just after; the snapshot-mask and segment-sum kernels
   must have run. The last epoch's window is answered again with the
   plain versions on the card: k-hop, reachability and top-k byte-equal,
   PageRank within atol 1e-6. Then ``segment_sum`` at the final
   snapshot's shape (m = its live edges, n = 1,048,576, F = 1 float32,
   1e-5 relative) against its plain version and ``torch.segment_reduce``.
4. A small stream served on the card and on the CPU (the plain path the
   CPU parity tests hold against the JAX package) must agree.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

N_VERTICES = 1 << 20
EPOCHS = 16
ADDS_PER_EPOCH = 1_000_000
SHARDS = 4
QUERIES_PER_EPOCH = 16
SEED = 0

MASK_N = 16_000_000
RESOLVE_N, RESOLVE_K = 4_000_000, 4
BF16_M, BF16_F = 1_000_000, 16


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on an H100 SXM for the work, in ms, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, source, replaces, *, max_abs_err, ms, plain_ms,
               nbytes, ops, library_ms, shape) -> dict:
    b_ms, b_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": shape}


# --------------------------------------------------------------- phase 2
def check_stamp_kernels(torch) -> list[dict]:
    from repro_torch.core.versioned import PACK32_NEVER, Version, \
        pack32_clamped
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    dev = "cuda"
    # stamps as the store packs them: epoch << 20, deletes later than
    # creates, 60% of rows never deleted (the int32-max sentinel)
    epoch = torch.randint(0, 16, (MASK_N,), generator=g, device=dev,
                          dtype=torch.int32)
    created = epoch << 20
    deleted = (epoch + torch.randint(1, 8, (MASK_N,), generator=g,
                                     device=dev, dtype=torch.int32)) << 20
    never = torch.rand(MASK_N, generator=g, device=dev) < 0.6
    deleted[never] = PACK32_NEVER
    q_mid = pack32_clamped(Version(8, 0))
    q_clamped = pack32_clamped(Version(1 << 30, 1 << 30))
    check(q_clamped == PACK32_NEVER - 1, "clamped query is not int32 max - 1")
    for q in (q_mid, q_clamped, 0):
        got = ops.liveness_mask(created, deleted, q, use_kernel=True)
        want = ref.liveness_mask(created, deleted, q)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"liveness_mask differs from its plain version at q={q}")
    ms = cuda_ms(torch, lambda: ops.liveness_mask(created, deleted, q_mid,
                                                  use_kernel=True))
    plain = cuda_ms(torch, lambda: ref.liveness_mask(created, deleted, q_mid))
    rows = [kernel_row(
        "liveness_mask", "src/repro_torch/csrc/snapshot_resolve.cu",
        "src/repro/kernels/snapshot_resolve.py:78", max_abs_err=0.0,
        ms=ms, plain_ms=plain, nbytes=9 * MASK_N, ops=3 * MASK_N,
        library_ms=None, shape=f"N={MASK_N}")]
    del created, deleted, never, epoch

    # (N, K) ascending version rows, int32-max padded past a random fill
    raw = torch.randint(0, 1 << 24, (RESOLVE_N, RESOLVE_K), generator=g,
                        device=dev, dtype=torch.int32)
    versions = torch.sort(raw, dim=1).values
    fill = torch.randint(0, RESOLVE_K + 1, (RESOLVE_N, 1), generator=g,
                         device=dev)
    slot = torch.arange(RESOLVE_K, device=dev)[None, :]
    versions = torch.where(slot < fill, versions,
                           torch.full_like(versions, PACK32_NEVER))
    values = torch.randn(RESOLVE_N, RESOLVE_K, generator=g, device=dev)
    q = 1 << 23
    got_v, got_i = ops.snapshot_resolve(versions, values, q, use_kernel=True)
    want_v, want_i = ref.snapshot_resolve(versions, values, q)
    torch.cuda.synchronize()
    check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
          "snapshot_resolve differs from its plain version")
    resolved = int((want_i >= 0).sum())
    ms = cuda_ms(torch, lambda: ops.snapshot_resolve(versions, values, q,
                                                     use_kernel=True))
    plain = cuda_ms(torch, lambda: ref.snapshot_resolve(versions, values, q))
    # versions read once, one value per resolved item, value + index out
    nbytes = RESOLVE_N * RESOLVE_K * 4 + resolved * 4 + RESOLVE_N * 8
    rows.append(kernel_row(
        "snapshot_resolve", "src/repro_torch/csrc/snapshot_resolve.cu",
        "src/repro/kernels/snapshot_resolve.py:39", max_abs_err=0.0,
        ms=ms, plain_ms=plain, nbytes=nbytes,
        ops=RESOLVE_N * RESOLVE_K, library_ms=None,
        shape=f"N={RESOLVE_N},K={RESOLVE_K},float32"))
    return rows


def check_segment_sum(torch, name, values, ids, n, rtol) -> dict:
    """Kernel vs plain version (and torch.segment_reduce, timed only)."""
    from repro_torch.kernels import ops, ref

    got = ops.segment_sum(values, ids, n, use_kernel=True)
    want = ref.segment_sum(values, ids, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= rtol * max(scale, 1e-30),
          f"{name}: max |kernel - plain| {err} exceeds {rtol} x {scale}")
    ms = cuda_ms(torch, lambda: ops.segment_sum(values, ids, n,
                                                use_kernel=True))
    plain = cuda_ms(torch, lambda: ref.segment_sum(values, ids, n))
    valid = int(((ids >= 0) & (ids < n)).sum())
    lengths = torch.bincount(ids[:valid].long(), minlength=n)
    data = values[:valid]
    library = cuda_ms(torch, lambda: torch.segment_reduce(
        data, "sum", lengths=lengths, axis=0))
    m, f = values.shape
    nbytes = m * f * values.element_size() + m * 4 + n * f * 4
    return kernel_row(
        name, "src/repro_torch/csrc/segment_sum.cu",
        "src/repro/kernels/segment_sum.py:50", max_abs_err=err, ms=ms,
        plain_ms=plain, nbytes=nbytes, ops=valid * f, library_ms=library,
        shape=f"m={m},n={n},F={f},{str(values.dtype).split('.')[-1]}")


def check_segment_sum_bf16(torch) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    n = N_VERTICES
    # ascending ids over [0, n], the last ones in the phantom segment n
    ids = torch.sort(torch.randint(0, n + 1, (BF16_M,), generator=g,
                                   device="cuda")).values.to(torch.int32)
    values = torch.randn(BF16_M, BF16_F, generator=g, device="cuda") \
        .to(torch.bfloat16)
    return check_segment_sum(torch, "segment_sum (bf16, F=16)", values, ids,
                             n, 3e-2)


# --------------------------------------------------------------- phase 3
def serve_stream(torch, device: str, n: int, epochs: int, adds: int, *,
                 on_last_window=None) -> dict:
    """The serving loop of ``repro_torch.launch.serve_graph.main`` on
    ``device``; returns the answers of every window and the server."""
    import numpy as np

    from repro_torch.graph.dyngraph import synthesize_churn_stream
    from repro_torch.graph.sharded import ShardedDynamicGraph
    from repro_torch.launch.serve_graph import GraphQueryServer, _demo_queries

    t0 = time.perf_counter()
    batches = synthesize_churn_stream(n, epochs, adds, seed=SEED,
                                      delete_frac=0.2)
    t_stream = time.perf_counter() - t0
    e_max = sum(len(b.add_src) for b in batches) + 16
    sg = ShardedDynamicGraph(SHARDS, n, e_max, device=device)
    server = GraphQueryServer(sg, prewarm_pagerank=True, tol=1e-6,
                              max_iter=200)
    rng = np.random.default_rng(SEED + 1)
    windows = []
    step_s, window_s = [], []
    try:
        for i, batch in enumerate(batches):
            last = i == len(batches) - 1
            base = None
            if last and on_last_window is not None:
                # the ranks the server warm-starts the last epoch from
                prev = sg.join_view(sg.latest_sealed())
                base = server.engine.pagerank(prev)
            t = time.perf_counter()
            server.step(batch)
            if device != "cpu":
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            qs = _demo_queries(rng, n, QUERIES_PER_EPOCH)
            for q in qs:
                server.submit(q)
            t = time.perf_counter()
            pairs = server.run_window()
            window_s.append(time.perf_counter() - t)
            check(len(pairs) == len(qs),
                  f"epoch {i}: {len(pairs)} responses for {len(qs)} queries")
            for req, resp in pairs:
                check(resp.ok, f"epoch {i}: query {req.query} failed: "
                               f"{resp.error}")
                check(resp.version == batch.version,
                      f"epoch {i}: answered at {resp.version}, expected "
                      f"{batch.version}")
            windows.append([(req.query, resp.value) for req, resp in pairs])
            if last and on_last_window is not None:
                on_last_window(server, sg.join_view(batch.version), qs,
                               [resp.value for _, resp in pairs], base)
        stats = server.stats()
    finally:
        server.stop_prewarm()
        sg.shutdown()
    check(stats.seal_failures == 0, f"{stats.seal_failures} seal failures")
    check(stats.served == epochs * QUERIES_PER_EPOCH,
          f"served {stats.served} of {epochs * QUERIES_PER_EPOCH}")
    return {"windows": windows, "stats": stats, "stream_s": t_stream,
            "step_s": step_s, "window_s": window_s, "graph": sg,
            "server": server}


def same_answer(np, a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_answer(np, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def recheck_last_window(torch, checks: dict):
    """Answer the last window again with the plain versions on the card."""
    import numpy as np

    from repro_torch.device import to_host
    from repro_torch.graph import compute as gc
    from repro_torch.graph.query import PageRankQuery, SnapshotQueryEngine

    def recheck(server, view, queries, values, base):
        plain_engine = SnapshotQueryEngine(result_cache=False, tol=1e-6,
                                           max_iter=200, use_kernel=False)
        others = [(q, v) for q, v in zip(queries, values)
                  if not isinstance(q, PageRankQuery)]
        plain = plain_engine.execute(view, [q for q, _ in others])
        for (q, got), want in zip(others, plain):
            check(same_answer(np, got, want),
                  f"last window: {q} differs from the plain answer")
        served = server.engine.pagerank(view)
        ranks = gc.incremental_pagerank(base, None, view, tol=1e-6,
                                        max_iter=200, use_kernel=False)
        a, b = to_host(served.ranks), to_host(ranks.ranks)
        diff = float(np.abs(a - b).max())
        check(a.dtype == b.dtype == np.float32 and a.shape == b.shape,
              "PageRank ranks dtype/shape")
        check(bool(np.isfinite(a).all()) and abs(float(a.sum()) - 1) < 1e-3,
              "PageRank ranks not a finite distribution")
        check(diff <= 1e-6, f"PageRank kernel vs plain max diff {diff}")
        check(abs(served.iterations - ranks.iterations) <= 1,
              f"PageRank iterations {served.iterations} vs "
              f"{ranks.iterations}")
        for q, got in zip(queries, values):
            if isinstance(q, PageRankQuery):
                ids, vals = got
                check(bool(np.allclose(vals, b[ids], rtol=0, atol=1e-6)),
                      "PageRank top-k values differ from the plain ranks")
        checks.update(pagerank_max_diff=diff,
                      pagerank_iterations=[served.iterations,
                                           ranks.iterations],
                      recheck_queries=len(queries))
    return recheck


def check_small_cpu_agreement(torch) -> int:
    """A small stream served on the card and on the CPU agrees."""
    import numpy as np

    from repro_torch.graph.query import PageRankQuery

    args = (4096, 4, 4000)
    gpu = serve_stream(torch, "cuda", *args)
    cpu = serve_stream(torch, "cpu", *args)
    compared = 0
    for wg, wc in zip(gpu["windows"], cpu["windows"]):
        for (q, a), (_, b) in zip(wg, wc):
            if isinstance(q, PageRankQuery):
                check(np.allclose(a[1], b[1], rtol=0, atol=1e-6),
                      "small stream: PageRank differs between card and CPU")
            else:
                check(same_answer(np, a, b),
                      f"small stream: {q} differs between card and CPU")
            compared += 1
    return compared


# ------------------------------------------------------------------- main
def main() -> int:
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _lib, ops

    t_all = time.perf_counter()
    card = device_line()
    log(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t = time.perf_counter()
    _lib.load()
    log(f"phase 1 build: {time.perf_counter() - t:.3f} s "
        f"(nvcc {_lib.build_seconds})")

    t = time.perf_counter()
    rows = check_stamp_kernels(torch)
    rows.append(check_segment_sum_bf16(torch))
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    checks: dict = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve_stream(torch, "cuda", N_VERTICES, EPOCHS, ADDS_PER_EPOCH,
                       on_last_window=recheck_last_window(torch, checks))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    slice_s = time.perf_counter() - t
    check(counts["liveness_mask"] > 0, "serving never launched liveness_mask")
    check(counts["segment_sum"] > 0, "serving never launched segment_sum")
    st = run["stats"]
    view = run["graph"].join_view(run["graph"].latest_sealed())
    log(f"phase 3 slice: {slice_s:.3f} s (stream {run['stream_s']:.3f} s, "
        f"steps {sum(run['step_s']):.3f} s, windows "
        f"{sum(run['window_s']):.3f} s); served {st.served} queries, "
        f"p50 {st.query_p50_s * 1e3:.3f} ms, p99 {st.query_p99_s * 1e3:.3f}"
        f" ms; final snapshot m={view.m}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{counts}; recheck {checks}")
    log("phase 3 per-epoch step s: "
        + " ".join(f"{x:.3f}" for x in run["step_s"]))
    log("phase 3 per-epoch window s: "
        + " ".join(f"{x:.3f}" for x in run["window_s"]))

    t = time.perf_counter()
    pr = torch.rand(N_VERTICES, device="cuda")
    contrib = (pr / torch.clamp(view.out_degree, min=1.0))[view.src]
    rows.append(check_segment_sum(torch, "segment_sum", contrib[:, None]
                                  .contiguous(), view.dst, view.n, 1e-5))
    del run, view, contrib
    compared = check_small_cpu_agreement(torch)
    log(f"phase 4 final-shape segment_sum + card/CPU agreement on "
        f"{compared} answers: {time.perf_counter() - t:.3f} s")

    for row in rows:
        base = row["name"].split(" ")[0]
        row["launches"] = counts[base]
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"imported {leaked[:5]}")
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
