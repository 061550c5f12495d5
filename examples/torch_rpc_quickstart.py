"""RPC serving-tier quickstart on the PyTorch port: a real server process
with its store on ``--device``, real socket clients.

Launches ``python -m repro_torch.launch.serve_graph --device <dev>
--rpc-port 0`` as a subprocess (its own process, its own GIL), parses the
ephemeral port off the one ``RPC listening on host:port`` line it prints,
then drives it with concurrent ``GraphRPCClient`` threads while the
server is still ingesting its synthetic stream in the background —
queries are answered at the newest *sealed* epoch while the next epoch's
applies run concurrently (the epoch-pipelined read plane).

Each client sends typed k-hop / reachability / degree-top-k queries and
checks the typed ``QueryResponse`` envelope; one client additionally
re-asks an answered query pinned to the version the first answer was
served at and verifies the replay is byte-identical — the wire codec
ships ndarrays as raw dtype+shape+bytes precisely so this holds across
the socket. After the run every answer is held byte for byte against a
single-store replay of the server's stream on the CPU at the version it
was served from. Closing the subprocess's stdin is the shutdown signal.

    PYTHONPATH=src python examples/torch_rpc_quickstart.py

The sizes are the JAX package's quickstart's. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain path
on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import threading

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import numpy as np

from repro_torch.core.versioned import Version
from repro_torch.graph.dyngraph import synthesize_churn_stream
from repro_torch.graph.query import DegreeTopK, KHop, Reachability
from repro_torch.launch.rpc import GraphRPCClient
from torch_crash_recovery_demo import (prebuild, read_until, same_answer,
                                       spawn_serve_graph)
from torch_serve_graph_live import audit


@dataclasses.dataclass(frozen=True)
class RpcRun:
    """One run; the defaults are the JAX quickstart's sizes."""
    clients: int = 4
    queries_per_client: int = 12
    vertices: int = 800
    epochs: int = 6
    adds: int = 600
    shards: int = 2
    seed: int = 0               # the server's stream (serve_graph's --seed)
    ingest_delay_s: float = 0.05
    timeout_s: float = 300.0


def serve_subprocess(run: RpcRun, device):
    return spawn_serve_graph(device, [
        "--vertices", str(run.vertices), "--epochs", str(run.epochs),
        "--adds-per-epoch", str(run.adds), "--shards", str(run.shards),
        "--seed", str(run.seed),
        "--ingest-delay-s", str(run.ingest_delay_s)])


def client_worker(run: RpcRun, host: str, port: int, seed: int,
                  out: list[str], answers: list) -> None:
    n = run.vertices
    rng = np.random.default_rng(seed)
    ok = shed = 0
    with GraphRPCClient(host, port, timeout_s=run.timeout_s) as cli:
        for i in range(run.queries_per_client):
            kind = i % 3
            if kind == 0:
                q = KHop(source=int(rng.integers(n)), k=2)
            elif kind == 1:
                q = Reachability(src=int(rng.integers(n)),
                                 dst=int(rng.integers(n)), max_hops=6)
            else:
                q = DegreeTopK(k=8)
            r = cli.query(q, deadline_s=30.0)
            if not r.ok:
                shed += 1       # typed shed (overload/deadline), not a crash
                continue
            ok += 1
            answers.append((q, r.version, r.value))
            if kind == 0 and ok == 1:
                # replay the same query pinned to the version it was just
                # answered at: byte-identical even though newer epochs may
                # have sealed in between
                pinned = cli.query(q, pin_version=r.version)
                if not (pinned.ok and same_answer(q, pinned.value, r.value)):
                    raise RuntimeError("pinned replay diverged from the "
                                       "live answer")
                out.append(f"client {seed}: pinned replay at "
                           f"epoch {r.version.epoch} is byte-identical")
    out.append(f"client {seed}: {ok} answered, {shed} shed (typed)")


def run_demo(run: RpcRun, device) -> dict:
    """Server subprocess on ``device``, the clients, the final stats and
    the audit; returns the facts, the answers among them."""
    prebuild(device)
    proc = serve_subprocess(run, device)
    lines: list[str] = []
    answers: list = []
    errors: list[BaseException] = []

    def worker(seed):
        try:
            client_worker(run, host, port, seed, lines, answers)
        except BaseException as exc:          # handed to the caller
            errors.append(exc)
    try:
        m = read_until(proc, r"RPC listening on (\S+):(\d+)")
        host, port = m.group(1), int(m.group(2))
        threads = [threading.Thread(target=worker, args=(seed,))
                   for seed in range(run.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(run.timeout_s)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("an RPC client hung")
        if errors:
            raise errors[0]
        with GraphRPCClient(host, port, timeout_s=run.timeout_s) as cli:
            s = cli.stats()
    finally:
        proc.stdin.close()        # the shutdown signal
        proc.wait(timeout=run.timeout_s)
    batches = synthesize_churn_stream(run.vertices, run.epochs, run.adds,
                                      seed=run.seed, delete_frac=0.2)
    checked = audit(run.vertices, batches, answers)
    serving = (Version.unpack(s["serving_version"])
               if s["serving_version"] is not None else None)
    return {"address": f"{host}:{port}", "lines": sorted(lines),
            "served": s["served"], "windows": s["windows"],
            "serving": serving, "shed_overload": s["shed_overload"],
            "shed_deadline": s["shed_deadline"], "audited": checked,
            "pinned": sum("pinned" in line for line in lines),
            "answers": answers, "returncode": proc.returncode}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the server subprocess's store")
    args = ap.parse_args()
    f = run_demo(RpcRun(), args.device)
    print(f"server subprocess up at {f['address']}")
    for line in f["lines"]:
        print(f"  {line}")
    print(f"server: {f['served']} served over {f['windows']} windows "
          f"(cross-client batching collapses same-kind queries), "
          f"serving {f['serving']}, shed {f['shed_overload']} overload / "
          f"{f['shed_deadline']} deadline")
    audited = ", ".join(f"{v} {k}" for k, v in sorted(f["audited"].items()))
    print(f"audited {audited} answers byte-identical against the single "
          "store on the CPU")
    print("OK: concurrent RPC clients served during live ingest")


if __name__ == "__main__":
    main()
