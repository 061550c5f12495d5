"""Crash-recovery walkthrough on the PyTorch port: kill -9 a serving
process, recover from its write-ahead log, audit.

The durable graph plane of ``repro_torch`` in one script:

1. launch ``python -m repro_torch.launch.serve_graph --device <dev>
   --rpc-port 0 --wal-dir ...`` as a subprocess: a serving process whose
   store lives on ``<dev>``, appending every sealed epoch to its
   write-ahead log and dropping a graph checkpoint every 4 epochs;
2. poll its RPC stats until the stream is several epochs in, then
   ``SIGKILL`` it mid-stream: no atexit, no flush;
3. recover the store in-process on ``<dev>`` from the WAL directory alone
   and audit it byte-identical against an uncrashed oracle (the same
   stream replayed into a fresh store on the CPU) at every epoch up to the
   durable frontier;
4. relaunch the server with ``--recover``: it resumes the stream after the
   durable frontier, drains the remaining epochs, and its answers over RPC
   at the final version equal the oracle's (k-hop, reachability and
   top-k byte for byte, PageRank within atol 1e-6).

The durable frontier is the minimum over the control log's commit records
and every shard's intact WAL records, so whatever the kill tore off the
end costs recovery depth, never correctness.

    PYTHONPATH=src python examples/torch_crash_recovery_demo.py [--smoke]

By default the stream is 10 epochs of 250,000 adds on 262,144 vertices in
4 shards; ``--smoke`` runs the JAX package's demo sizes (600 vertices, 2
shards).

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain path on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.versioned import Version
from repro_torch.device import resolve_device, to_host
from repro_torch.graph.dyngraph import synthesize_churn_stream
from repro_torch.graph.query import (DegreeTopK, KHop, PageRankQuery,
                                     Reachability, SnapshotQueryEngine)
from repro_torch.graph.sharded import ShardedDynamicGraph
from repro_torch.launch.rpc import GraphRPCClient


@dataclasses.dataclass(frozen=True)
class CrashRun:
    """One run of the demo. The defaults are the card-sized run;
    :data:`SMOKE` holds the JAX demo's own sizes."""
    vertices: int = 262_144
    epochs: int = 10
    adds: int = 250_000
    shards: int = 4
    seed: int = 0
    checkpoint_every: int = 4
    kill_after_epoch: int = 5     # past the epoch-3 checkpoint
    ingest_delay_s: float = 0.05
    device: str = "cuda"
    timeout_s: float = 300.0


SMOKE = CrashRun(vertices=600, epochs=10, adds=400, shards=2, seed=7)
QUERIES = 12                       # compared at the final version


def spawn_serve_graph(device, args: list[str]) -> subprocess.Popen:
    """Start the port's graph server (``python -m
    repro_torch.launch.serve_graph --device <device> --rpc-port 0
    <args>``) from the repository root, with the port's sources on its
    path; it announces its address on one line (:func:`read_until`) and
    stops when its stdin closes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_graph",
           "--device", str(device), "--rpc-port", "0", *args]
    return subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)


def prebuild(device) -> None:
    """Resolve ``device``; on a card, build the kernels here, once, so
    that server subprocesses load the built library instead of racing to
    build it."""
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _lib
        _lib.load()


def launch(run: CrashRun, wal_dir, *, recover: bool) -> subprocess.Popen:
    """Start the port's graph server on ``run.device`` over the RPC front,
    with its write-ahead log under ``wal_dir``."""
    args = ["--wal-dir", str(wal_dir),
            "--checkpoint-every", str(run.checkpoint_every),
            "--vertices", str(run.vertices), "--epochs", str(run.epochs),
            "--adds-per-epoch", str(run.adds), "--shards", str(run.shards),
            "--seed", str(run.seed),
            "--ingest-delay-s", str(run.ingest_delay_s)]
    if recover:
        args.append("--recover")
    return spawn_serve_graph(run.device, args)


def read_until(proc: subprocess.Popen, pattern: str) -> re.Match:
    """Read the server's output until a line matches ``pattern``."""
    while True:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"server exited (code {proc.poll()}) before "
                               f"printing {pattern!r}")
        m = re.match(pattern, line)
        if m:
            return m


def serving_epoch(cli: GraphRPCClient) -> int:
    packed = cli.stats()["serving_version"]
    return -1 if packed is None else Version.unpack(packed).epoch


def stream_of(run: CrashRun):
    """The server's stream (``serve_graph``'s own generator call)."""
    batches = synthesize_churn_stream(run.vertices, run.epochs, run.adds,
                                      seed=run.seed, delete_frac=0.2)
    return batches, sum(len(b.add_src) for b in batches) + 16


def kill_mid_stream(run: CrashRun, wal_dir) -> dict:
    """Steps 1-2: serve with the WAL on, SIGKILL once the published
    snapshot reaches ``run.kill_after_epoch``."""
    t0 = time.perf_counter()
    proc = launch(run, wal_dir, recover=False)
    try:
        m = read_until(proc, r"RPC listening on (\S+):(\d+)")
        host, port = m.group(1), int(m.group(2))
        deadline = time.monotonic() + run.timeout_s
        with GraphRPCClient(host, port) as cli:
            while serving_epoch(cli) < run.kill_after_epoch:
                if time.monotonic() > deadline:
                    raise RuntimeError("stream never reached the kill epoch")
                time.sleep(0.02)
            seen = serving_epoch(cli)
    finally:
        proc.kill()                                 # SIGKILL: no cleanup
        proc.wait(timeout=60)
    return {"seen": seen, "kill_s": time.perf_counter() - t0,
            "returncode": proc.returncode}


def _same_view(got, want) -> bool:
    return all(np.array_equal(to_host(getattr(got, f)),
                              to_host(getattr(want, f)))
               and to_host(getattr(got, f)).dtype
               == to_host(getattr(want, f)).dtype
               for f in ("offsets", "src", "dst", "out_degree",
                         "in_degree"))


def recover_and_audit(run: CrashRun, wal_dir) -> dict:
    """Step 3: recover on ``run.device`` from the log alone; every epoch
    up to the durable frontier byte-identical to an uncrashed replay on
    the CPU. The recovered store's log is released for the relaunch."""
    t0 = time.perf_counter()
    rec = ShardedDynamicGraph.recover(wal_dir, device=run.device)
    recover_s = time.perf_counter() - t0
    frontier = rec.coordinator.global_frontier
    if not run.checkpoint_every - 1 <= frontier < run.epochs:
        raise RuntimeError(f"durable frontier {frontier} outside "
                           f"[{run.checkpoint_every - 1}, {run.epochs})")
    batches, e_max = stream_of(run)
    oracle = ShardedDynamicGraph(run.shards, run.vertices, e_max,
                                 device="cpu")
    audited = 0
    for b in batches[:frontier + 1]:
        oracle.apply(b)
        if not _same_view(rec.join_view(b.version),
                          oracle.join_view(b.version)):
            raise RuntimeError(f"epoch {b.version.epoch}: the recovered "
                               "view differs from the oracle's")
        audited += 1
    for w in rec.wal_shards:                        # release the log before
        if w is not None:                           # the relaunch reopens it
            w.close()
    rec.wal.close()
    rec.shutdown()
    return {"frontier": frontier, "audited": audited,
            "recover_s": recover_s, "oracle": oracle, "batches": batches}


def final_queries(run: CrashRun) -> list:
    rng = np.random.default_rng(run.seed + 1)
    n = run.vertices
    qs = []
    for i in range(QUERIES):
        if i % 4 == 0:
            qs.append(KHop(int(rng.integers(n)), k=2))
        elif i % 4 == 1:
            qs.append(Reachability(int(rng.integers(n)),
                                   int(rng.integers(n)), max_hops=6))
        elif i % 4 == 2:
            qs.append(DegreeTopK(8))
        else:
            qs.append(PageRankQuery())      # the whole rank vector
    return qs


def same_answer(q, got, want) -> bool:
    """k-hop, reachability and top-k byte for byte; PageRank's ranks
    within atol 1e-6 (the card and the CPU sum in different orders)."""
    if isinstance(q, PageRankQuery):
        g, w = to_host(got), to_host(want)
        return g.shape == w.shape and bool(
            np.allclose(g, w, rtol=0, atol=1e-6))
    if isinstance(want, tuple):
        return all(to_host(a).tobytes() == to_host(b).tobytes()
                   and to_host(a).dtype == to_host(b).dtype
                   for a, b in zip(got, want))
    if isinstance(want, bool):
        return got == want
    g, w = to_host(got), to_host(want)
    return g.dtype == w.dtype and g.tobytes() == w.tobytes()


def resume_and_compare(run: CrashRun, wal_dir, audit: dict) -> dict:
    """Step 4: relaunch with ``--recover``, drain the stream, and hold the
    answers over RPC at the final version against the oracle's."""
    t0 = time.perf_counter()
    proc = launch(run, wal_dir, recover=True)
    try:
        m = read_until(proc, r"recovered at durable frontier (\d+); "
                             r"resuming (\d+) remaining epochs")
        if int(m.group(1)) != audit["frontier"]:
            raise RuntimeError(f"relaunch recovered at {m.group(1)}, not "
                               f"{audit['frontier']}")
        remaining = int(m.group(2))
        m = read_until(proc, r"RPC listening on (\S+):(\d+)")
        host, port = m.group(1), int(m.group(2))
        read_until(proc, r"stream drained")
        resume_s = time.perf_counter() - t0
        qs = final_queries(run)
        with GraphRPCClient(host, port, timeout_s=run.timeout_s) as cli:
            final = serving_epoch(cli)
            answers = [cli.query(q, deadline_s=run.timeout_s) for q in qs]
    finally:
        proc.stdin.close()                          # the shutdown signal
        proc.wait(timeout=120)
    if final != run.epochs - 1:
        raise RuntimeError(f"resumed server serves epoch {final}, not "
                           f"{run.epochs - 1}")
    oracle = audit["oracle"]
    for b in audit["batches"][audit["frontier"] + 1:]:
        oracle.apply(b)
    view = oracle.join_view(oracle.latest_sealed())
    engine = SnapshotQueryEngine(result_cache=False, tol=1e-6, max_iter=200)
    want = engine.execute(view, qs)
    for q, r, w in zip(qs, answers, want):
        if not r.ok or r.version.epoch != run.epochs - 1:
            raise RuntimeError(f"{q}: {r.error} at {r.version}")
        if not same_answer(q, r.value, w):
            raise RuntimeError(f"{q}: the resumed server's answer differs "
                               "from the oracle's")
    return {"remaining": remaining, "final_epoch": final,
            "resume_s": resume_s, "compared": len(qs),
            "returncode": proc.returncode}


def run_demo(run: CrashRun, wal_dir=None) -> dict:
    """The whole walkthrough; returns its readings (raises on a fault)."""
    prebuild(run.device)
    if wal_dir is None:
        wal_dir = tempfile.mkdtemp(prefix="torch_crash_demo_wal_")
    killed = kill_mid_stream(run, wal_dir)
    audit = recover_and_audit(run, wal_dir)
    resumed = resume_and_compare(run, wal_dir, audit)
    wal_bytes = sum(p.stat().st_size
                    for p in pathlib.Path(wal_dir).rglob("*") if p.is_file())
    return {"seen": killed["seen"], "kill_s": killed["kill_s"],
            "frontier": audit["frontier"], "audited": audit["audited"],
            "recover_s": audit["recover_s"], "resume_s": resumed["resume_s"],
            "remaining": resumed["remaining"],
            "final_epoch": resumed["final_epoch"],
            "compared": resumed["compared"], "wal_bytes": wal_bytes,
            "wal_dir": str(wal_dir)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the servers and the recovered store")
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX demo's sizes (600 vertices, 2 shards)")
    args = ap.parse_args()
    run = dataclasses.replace(SMOKE if args.smoke else CrashRun(),
                              device=args.device)
    out = run_demo(run)
    print(f"killed -9 while serving epoch {out['seen']} (of {run.epochs}) "
          f"after {out['kill_s']:.2f}s; WAL in {out['wal_dir']}")
    print(f"recovered on {run.device} at durable frontier {out['frontier']} "
          f"in {out['recover_s']:.2f}s; {out['audited']} views "
          "byte-identical to the uncrashed oracle on the CPU")
    print(f"relaunched with --recover: {out['remaining']} epochs resumed "
          f"and drained in {out['resume_s']:.2f}s; {out['compared']} "
          f"answers at epoch {out['final_epoch']} equal the oracle's")
    print("OK: kill -9 lost nothing the log had; recovery matched the "
          "oracle and serving resumed")


if __name__ == "__main__":
    main()
