"""Open-loop query load over the RPC front, in a process of its own.

    python bench/benchlib/loadgen.py '<json parameters>'

It imports neither torch nor the program: it speaks the RPC front's wire
format (a 4-byte big-endian length, then UTF-8 JSON; arrays as
``{"__nd__": [dtype, shape, base64]}``, tuples as ``{"__tup__": [...]}``)
over ``connections`` sockets. With zipfian keys it first reads the
stream's label permutation (``n`` int32s) from its standard input. Its
schedule is drawn from the seed
(:func:`schedule`): a fixed count of arrivals, uniform over the phase
(a Poisson process given its count), with each kind's share of the mix
exact and the kinds shuffled, so every seed offers the same work in
another order. It connects, waits for one line ``go <t>`` on its standard
input (``t`` a ``time.monotonic()`` reading: the clock is the machine's,
shared by every process), sends the warm-up phase's queries from ``t``
and the window's from ``t + warm_s``, each on time whatever the server
does, and times each from when it was due. It waits for the window's
answers until ``wait_s`` after the window closes, then writes one
``.npz`` on its standard output: per window query its due, send and
receive times, whether it was answered, the server's ``latency_s`` and
the version; and, for the queries sampled from the seed, the answers.
"""
from __future__ import annotations

import base64
import io
import json
import re
import socket
import struct
import sys
import threading
import time

import numpy as np

KINDS = ("k_hop", "reachability", "degree_topk", "pagerank")
_LEN = struct.Struct(">I")
_HEAD = re.compile(rb'^\{"id":(\d+),"ok":(true|false),"latency_s":([^,}]+)')
_TAIL = re.compile(rb'"version":(\d+|null)\}$')
WINDOW_ID0 = 1 << 24          # ids of window queries start here


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


class Keys:
    """Vertex keys: uniform, or YCSB's zipfian (``theta``): the exact
    distribution P(rank i) proportional to 1 / i**theta, which YCSB's
    generator approximates. Rank ``i`` is the vertex that the stream's
    label permutation (``labels``) gives to the Kronecker position
    ``FIXED[i]``, one permutation for every seed: so on every seed the
    hot keys sit at the same places of the Kronecker structure (the same
    expected degrees), and the seed changes the edges around them and
    the order of the queries, not how much work they take."""

    FIXED_SEED = 0x5EED

    def __init__(self, spec: dict, n: int, seed: int,
                 labels: np.ndarray | None = None):
        self.n = n
        self.dist = spec.get("dist", "uniform")
        if self.dist == "zipf":
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** spec["theta"]
            self.cdf = np.cumsum(w) / w.sum()
            fixed = np.random.default_rng(self.FIXED_SEED).permutation(n)
            self.vertex = np.asarray(labels)[fixed]
        elif self.dist != "uniform":
            raise ValueError(f"unknown key distribution {self.dist!r}")

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        if self.dist == "uniform":
            return rng.integers(0, self.n, size)
        ranks = np.searchsorted(self.cdf, rng.random(size), side="right")
        return self.vertex[np.minimum(ranks, self.n - 1)]


def schedule(seed: int, phase: int, rate: float, seconds: float,
             mix: dict, keys: Keys) -> tuple[np.ndarray, list[dict]]:
    """(offsets in seconds from the phase's start, query frames without
    ids) of one phase: ``round(rate * seconds)`` arrivals."""
    rng = _rng(seed, 100 + phase)
    count = int(round(rate * seconds))
    times = np.sort(rng.uniform(0.0, seconds, count))
    shares = [float(mix[k]["share"]) for k in KINDS]
    per = [int(round(s * count)) for s in shares]
    per[0] += count - sum(per)
    kinds = np.repeat(np.arange(len(KINDS)), per)
    rng.shuffle(kinds)
    a = keys.draw(rng, count)
    b = keys.draw(rng, count)
    frames = []
    for i, k in enumerate(kinds):
        kind = KINDS[k]
        args = dict(mix[kind].get("args", {}))
        if kind == "k_hop":
            args["source"] = int(a[i])
        elif kind == "reachability":
            args["src"], args["dst"] = int(a[i]), int(b[i])
        frames.append({"op": "query", "kind": kind, "query": args,
                       "pin": None, "deadline_s": None})
    return times, frames


def sample_ids(seed: int, count: int, size: int) -> np.ndarray:
    """Window query indices whose answers are checked, drawn from the
    seed."""
    rng = _rng(seed, 300)
    return np.sort(rng.choice(count, size=min(size, count), replace=False))


def decode_value(enc):
    if isinstance(enc, dict) and "__nd__" in enc:
        dtype, shape, b64 = enc["__nd__"]
        return np.frombuffer(base64.b64decode(b64), dtype=np.dtype(dtype)) \
            .reshape(shape)
    if isinstance(enc, dict) and "__tup__" in enc:
        return tuple(decode_value(v) for v in enc["__tup__"])
    if isinstance(enc, list):
        return [decode_value(v) for v in enc]
    return enc


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class Client:
    def __init__(self, p: dict, labels: np.ndarray | None):
        self.p = p
        self.seed = int(p["seed"])
        keys = Keys(p["keys"], int(p["n"]), self.seed, labels)
        self.warm = schedule(self.seed, 0, p["rate"], p["warm_s"], p["mix"],
                             keys)
        self.win = schedule(self.seed, 1, p["rate"], p["seconds"], p["mix"],
                            keys)
        count = len(self.win[0])
        self.sampled = set(sample_ids(self.seed, count,
                                      int(p["sample"])).tolist())
        self.due = np.zeros(count)
        self.sent = np.zeros(count)
        self.recv = np.full(count, np.nan)
        self.state = np.zeros(count, np.int8)      # 1 ok, -1 error, 0 none
        self.lat = np.full(count, np.nan)
        self.version = np.full(count, -1, np.int64)
        self.answers: dict[int, object] = {}
        self.socks = []
        for _ in range(int(p["connections"])):
            s = socket.create_connection((p["host"], int(p["port"])),
                                         timeout=None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.socks.append(s)
        self.pending = count
        self.lock = threading.Lock()
        self.all_in = threading.Event()
        if not count:
            self.all_in.set()

    def _frames(self, frames, id0):
        out = []
        for i, f in enumerate(frames):
            body = json.dumps({**f, "id": id0 + i},
                              separators=(",", ":")).encode()
            out.append(_LEN.pack(len(body)) + body)
        return out

    def _receive(self, sock: socket.socket) -> None:
        while True:
            head = _read_exact(sock, 4)
            if head is None:
                return
            body = _read_exact(sock, _LEN.unpack(head)[0])
            if body is None:
                return
            t = time.monotonic()
            m = _HEAD.match(body)
            if m is None:
                frame = json.loads(body)
                rid, ok, lat = frame["id"], frame["ok"], frame["latency_s"]
            else:
                rid, ok, lat = (int(m.group(1)), m.group(2) == b"true",
                                float(m.group(3)))
            if rid < WINDOW_ID0:
                continue
            i = rid - WINDOW_ID0
            if ok and i in self.sampled:
                frame = json.loads(body)
                self.answers[i] = decode_value(frame["value"])
                version = frame["version"]
            elif ok:
                tail = _TAIL.search(body, max(0, len(body) - 64))
                version = (json.loads(body)["version"] if tail is None
                           else (None if tail.group(1) == b"null"
                                 else int(tail.group(1))))
            else:
                version = None
            self.recv[i] = t
            self.lat[i] = lat
            self.state[i] = 1 if ok else -1
            self.version[i] = -1 if version is None else version
            with self.lock:
                self.pending -= 1
                if self.pending == 0:
                    self.all_in.set()

    def _send(self, t0: float, times, frames) -> np.ndarray:
        sent = np.zeros(len(frames))
        n = len(self.socks)
        for i, data in enumerate(frames):
            wait = t0 + times[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            sent[i] = time.monotonic()
            self.socks[i % n].sendall(data)
        return sent

    def run(self, t0: float) -> None:
        warm = self._frames(self.warm[1], 0)
        win = self._frames(self.win[1], WINDOW_ID0)
        for s in self.socks:
            threading.Thread(target=self._receive, args=(s,),
                             daemon=True).start()
        self._send(t0, self.warm[0], warm)
        t_win = t0 + float(self.p["warm_s"])
        self.due = t_win + self.win[0]
        self.sent = self._send(t_win, self.win[0], win)
        close = t_win + float(self.p["seconds"])
        self.all_in.wait(max(0.0, close + float(self.p["wait_s"])
                             - time.monotonic()))
        for s in self.socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()

    def dump(self) -> bytes:
        arrays = {"due": self.due, "sent": self.sent, "recv": self.recv,
                  "state": self.state, "lat": self.lat,
                  "version": self.version,
                  "kind": np.asarray([KINDS.index(f["kind"])
                                      for f in self.win[1]], np.int8)}
        for i, val in self.answers.items():
            parts = val if isinstance(val, tuple) else (val,)
            for j, part in enumerate(parts):
                arr = np.asarray(part)
                if arr.dtype == np.bool_ and arr.ndim == 1:
                    arrays[f"a{i}_{j}_bits"] = np.packbits(arr)
                    arrays[f"a{i}_{j}_n"] = np.asarray(arr.size)
                else:
                    arrays[f"a{i}_{j}"] = arr
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()


def load_answers(npz) -> dict[int, tuple]:
    """The sampled answers of :meth:`Client.dump`, by window index."""
    parts: dict[int, dict[int, object]] = {}
    for key in npz.files:
        if not key.startswith("a") or key.endswith("_n"):
            continue
        i, j = (int(x) for x in key[1:].split("_")[:2])
        arr = npz[key]
        if key.endswith("_bits"):
            size = int(npz[f"a{i}_{j}_n"])
            arr = np.unpackbits(arr, count=size).astype(bool)
        parts.setdefault(i, {})[j] = arr
    return {i: tuple(p[j] for j in sorted(p)) for i, p in parts.items()}


def main() -> int:
    p = json.loads(sys.argv[1])
    labels = None
    if p["keys"].get("dist") == "zipf":
        # the stream's label permutation, n int32s, ahead of the go line
        raw = sys.stdin.buffer.read(4 * int(p["n"]))
        labels = np.frombuffer(raw, np.int32)
    client = Client(p, labels)
    line = sys.stdin.buffer.readline().decode().split()
    if len(line) != 2 or line[0] != "go":
        return 2
    client.run(float(line[1]))
    sys.stdout.buffer.write(client.dump())
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
