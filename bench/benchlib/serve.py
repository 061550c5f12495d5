"""The serving cells: live ingest and queries over the RPC front.

Set-up builds the configuration's store on the card and a
``GraphQueryServer`` over it, starts the RPC front on 127.0.0.1 (port 0)
and the load generator (``loadgen.py``) in a process of its own, and
loads the base through ``GraphQueryServer.step``, one epoch at a time.
Then, from one instant, the writer thread hands stream epochs to
``step`` (closed loop: each as soon as the last is published; open loop:
one every ``period_s``) while the load generator sends its warm-up
phase and then the window's queries. Set-up ends where the window opens.

A subscriber to the store's seal notifications records each publish: its
time and a digest of the snapshot the server publishes, which the check
holds against the reference. The counters the readers difference are read
at the window's open and close straight from the server's, engine's and
store's attributes, without ``stats()``, which would wait for the write
lock that a seal holds for seconds.
"""
from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchlib import check, loadgen, program
from benchlib.stream import KroneckerStream

LOADGEN = pathlib.Path(__file__).resolve().parent / "loadgen.py"


class Writer:
    """Hands stream epochs to ``server.step`` on a thread of its own."""

    def __init__(self, run, server, stream, layout, spec: dict):
        self.run, self.server = run, server
        self.stream, self.layout = stream, layout
        self.period = float(spec["period_s"]) if spec["mode"] == "open" \
            else 0.0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, name="bench-writer",
                                       daemon=True)
        self.t = 1
        self.error = None

    def start(self, t0: float) -> None:
        self.t0 = t0
        self.thread.start()

    def _loop(self) -> None:
        try:
            k = 0
            while not self.stop.is_set():
                epoch = self.layout.epoch_of_stream(self.t)
                batch = program.mutation_batch(self.stream, self.layout,
                                               epoch)
                due = self.t0 + k * self.period
                if self.stop.wait(max(0.0, due - time.monotonic())):
                    return
                self.run.epoch_mutations[epoch] = batch.size
                start = time.monotonic()
                self.server.step(batch)
                self.run.spans.append(("step", start, time.monotonic(),
                                       {"epoch": epoch}))
                if self.server.seal_failures:
                    self.error = (f"seal of epoch {epoch} failed (edge "
                                  "capacity reached?); the writer stops")
                    print(self.error, file=sys.stderr, flush=True)
                    return
                self.t += 1
                k += 1
        except Exception as exc:   # reported as a failed run, not a hang
            self.error = f"writer: {exc!r}"
            print(self.error, file=sys.stderr, flush=True)


class Cell:
    """The program set up under a serving cell's configuration: the store
    with its base loaded through ``step``, the server, its RPC front and
    the publish recorder. :meth:`loadgen` starts a load generator against
    it; :meth:`close` stops the front and the store's pool."""

    def __init__(self, run, device, capacity_epochs: int | None = None):
        from repro_torch.launch.rpc import GraphRPCServer
        from repro_torch.launch.serve_graph import GraphQueryServer

        cfg, tr = run.config, run.traffic
        self.run = run
        self.layout = program.layout_of(cfg, tr["writer"]["epoch_blocks"])
        self.stream = KroneckerStream(
            cfg["generator"], cfg["block_edges"], run.seed, device,
            keep=self.layout.base_blocks + self.layout.epoch_blocks)
        e_max = program.edge_capacity(
            cfg, self.layout, capacity_epochs or tr["capacity_epochs"])
        self.sg = sg = program.build_store(cfg, e_max, device)
        self.server = GraphQueryServer(sg, **cfg["server"])

        def on_publish(_frontier: int) -> None:
            v = sg.latest_sealed()
            run.publishes.append((time.monotonic(), v.pack(),
                                  program.digest_of(sg.join_view(v))))

        sg.on_frontier_advance(on_publish)
        self.rpc = GraphRPCServer(self.server, port=0).start()

    def load_base(self) -> None:
        for e in range(self.layout.base_epochs):
            batch = program.mutation_batch(self.stream, self.layout, e)
            self.run.epoch_mutations[e] = batch.size
            self.server.step(batch)

    def loadgen(self, queries: dict, seed: int, warm_s: float,
                seconds: float) -> subprocess.Popen:
        host, port = self.rpc.address
        params = {"host": host, "port": port, "seed": seed,
                  "rate": queries["rate_per_s"], "warm_s": warm_s,
                  "seconds": seconds, "wait_s": queries["wait_s"],
                  "connections": queries["connections"],
                  "mix": queries["mix"], "keys": queries["keys"],
                  "n": self.stream.n, "sample": queries["sample"]}
        gen = subprocess.Popen(
            [sys.executable, str(LOADGEN), json.dumps(params)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        if queries["keys"].get("dist") == "zipf":
            gen.stdin.write(self.labels().tobytes())
            gen.stdin.flush()
        return gen

    def labels(self) -> np.ndarray:
        return self.stream.perm.cpu().numpy().astype(np.int32)

    def counters(self) -> dict:
        server, sg = self.server, self.sg
        e = server.engine
        return {"served": server.served, "windows": server.windows,
                "shed_overload": server.shed_overload,
                "shed_deadline": server.shed_deadline,
                "mirror_hits": e.mirror_hits,
                "mirror_misses": e.mirror_misses,
                "result_cache_hits": e.result_cache_hits,
                "result_cache_misses": e.result_cache_misses,
                "view_delta_patches": sg.view_delta_patches,
                "view_full_builds": sg.view_full_builds,
                "reshards": len(sg.migrations),
                "seal_failures": server.seal_failures}

    def close(self) -> None:
        self.rpc.stop()
        self.sg.shutdown()


def go(gen: subprocess.Popen, t_start: float) -> None:
    gen.stdin.write(f"go {t_start!r}\n".encode())
    gen.stdin.flush()


def collect(gen: subprocess.Popen, timeout: float) -> dict:
    """The load generator's arrays, once it has exited."""
    out, _ = gen.communicate(timeout=timeout)
    if gen.returncode != 0:
        raise RuntimeError(f"load generator exited {gen.returncode}")
    npz = np.load(io.BytesIO(out))
    q = {k: npz[k] for k in ("due", "sent", "recv", "state", "lat",
                             "version", "kind")}
    q["answers"] = loadgen.load_answers(npz)
    return q


def run_cell(run, device, t_proc: float, trace_window=None) -> dict:
    """Drive one serving cell through set-up and its window; returns what
    the check needs once the program's state is freed."""
    tr = run.traffic
    cell = Cell(run, device)
    run.wait_s = float(tr["queries"]["wait_s"])
    gen = cell.loadgen(tr["queries"], run.seed, tr["warm_s"], run.seconds)
    writer = None
    try:
        cell.load_base()
        writer = Writer(run, cell.server, cell.stream, cell.layout,
                        tr["writer"])
        t_start = time.monotonic() + 0.5
        run.t_open = t_start + float(tr["warm_s"])
        run.t_close = run.t_open + run.seconds
        go(gen, t_start)
        writer.start(t_start)
        _sleep_until(run.t_open)
        run.counters["open"] = cell.counters()
        run.setup_s = run.t_open - t_proc
        if trace_window is not None:
            _sleep_until(run.t_open + tr["trace_offset_s"])
            trace_window.start()
            _sleep_until(trace_window.t0 + tr["trace_s"])
            trace_window.stop()
        _sleep_until(run.t_close)
        run.counters["close"] = cell.counters()
        writer.stop.set()
        run.queries = collect(gen, run.wait_s + 60)
        writer.thread.join(timeout=120)
        if writer.thread.is_alive():
            raise RuntimeError("the writer's step did not return")
    finally:
        if writer is not None:
            writer.stop.set()
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        cell.close()
    steps = [round(e - s, 3) for name, s, e, _ in run.spans
             if name == "step"]
    late = (run.queries["sent"] - run.queries["due"]) * 1e3
    print(f"writer steps (s): {steps}\ncounters: {run.counters}\n"
          f"load generator late by (ms): p50 {np.median(late):.3f}, "
          f"max {late.max():.3f}", file=sys.stderr, flush=True)
    run.attempted = int(len(run.queries["due"]))
    run.failed = int((run.queries["state"] != 1).sum())
    if writer.error:
        run.failed += 1
        run.notes.append(writer.error)
    run.publishes = [(t, v, d.tolist()) for t, v, d in run.publishes]
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    state = {"stream": cell.stream, "layout": cell.layout,
             "memory_peak_bytes": peak}
    del cell, writer
    return state


def numbers(run, state: dict, config: dict, control: bool) -> dict:
    """The serving cell's compared numbers (``check.serve_numbers``)."""
    return check.serve_numbers(run, state["stream"], state["layout"],
                               config["reference_pagerank"], control=control)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))
