"""Socket RPC front for the graph query server: wire codec + listener.

This is the network half of the serving tier (``docs/ARCHITECTURE.md``,
"Serving tier"): a :class:`GraphRPCServer` puts a TCP listener in front of
one in-process :class:`~repro_torch.launch.serve_graph.GraphQueryServer`, so
many concurrent clients share ONE store, ONE published snapshot and ONE
query scheduler — their same-kind queries collapse into the same
vectorized window, exactly as if one caller had batched them.

Wire format (deliberately dependency-free — stdlib ``socket`` + ``json``
+ ``base64``): every frame is a 4-byte big-endian unsigned length prefix
followed by that many bytes of UTF-8 JSON. Query values survive the trip
**byte-identically**: an ndarray is encoded as its dtype string, shape and
the base64 of ``tobytes()``, so the soak test's replay oracle can compare
served bytes against a single-store recompute with ``==`` on the buffers,
not an epsilon. Snapshot versions travel as their packed ``(epoch,
batch)`` int (``Version.pack``). The frames are the JAX package's own
(``repro.launch.rpc``), byte for byte, so a client of either package
talks to a server of the other; answers computed on a card cross to the
host before they are framed.

Request frames::

    {"op": "query", "id": <int|str>, "kind": "k_hop", "query": {...},
     "pin": <packed-version|null>, "deadline_s": <float|null>}
    {"op": "stats", "id": <int|str>}

Response frames mirror :class:`~repro_torch.graph.query.QueryResponse`::

    {"id": ..., "ok": true,  "value": <enc>, "version": <packed>,
     "latency_s": <float>}
    {"id": ..., "ok": false, "error": {"code": "...", "message": "..."},
     "latency_s": <float>}

Threading model: one accept thread, one reader thread per connection, and
one dispatcher thread PER SCHEDULER LANE (cheap/expensive; a single
dispatcher when the server runs single-queue) that runs the shared
scheduler (``GraphQueryServer.run_window``) whenever work is queued on
its lane — so a multi-iteration PageRank window on the expensive
dispatcher never blocks the cheap dispatcher's dict-lookup windows.
Readers never execute queries — they decode, pass the typed
:class:`~repro_torch.graph.query.QueryRequest` to ``submit_request`` with an
``on_done`` that frames the response back onto their own connection, and
go back to reading. Admission control therefore happens at the server's
single bounded queue: when it is full the shed ``ERR_OVERLOADED``
response comes back on the submitting connection immediately (written
inline by the reader), so an overloaded server degrades into fast typed
rejections instead of unbounded queueing. Per-connection write locks
(plain locals, one socket each) keep concurrently-delivered frames from
interleaving.

The dispatcher never dies with a failed window: the scheduler's
all-or-nothing contract re-queues undelivered requests, and the
dispatcher retries after a short pause — e.g. queries that race ahead of
the first global seal simply wait (their deadline, if any, still
applies).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import random
import socket
import struct
import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.versioned import Version
from repro_torch.device import to_host
from repro_torch.graph.query import (ERR_BAD_QUERY, ERR_OVERLOADED, DegreeTopK,
                               KHop, PageRankQuery, Query, QueryRequest,
                               QueryResponse, Reachability)
from repro_torch.launch.serve_graph import GraphQueryServer

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024    # refuse absurd frames instead of OOMing

_QUERY_TYPES = {"k_hop": KHop, "reachability": Reachability,
                "degree_topk": DegreeTopK, "pagerank": PageRankQuery}


# ---------------------------------------------------------------- codec
def encode_frame(obj: dict) -> bytes:
    """One wire frame: 4-byte big-endian length + UTF-8 JSON body."""
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame of {len(body)} bytes exceeds MAX_FRAME")
    return _LEN.pack(len(body)) + body


def read_frame(sock: socket.socket) -> Optional[dict]:
    """Read one frame off ``sock``; None on clean EOF at a frame
    boundary. Raises ``ConnectionError`` on a mid-frame disconnect and
    ``ValueError`` on an oversized length prefix."""
    header = _read_exact(sock, _LEN.size, eof_ok=True)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME")
    body = _read_exact(sock, length, eof_ok=False)
    return json.loads(body.decode("utf-8"))


def _read_exact(sock: socket.socket, n: int, *,
                eof_ok: bool) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def encode_value(value) -> object:
    """JSON-encode a query answer, byte-exactly for arrays: ndarray ->
    ``{"__nd__": [dtype-str, shape, base64(tobytes())]}`` (dtype strings
    keep byte order, so decode reproduces the exact buffer); tuples ->
    ``{"__tup__": [...]}`` so (ids, degrees) pairs round-trip as tuples;
    numpy scalars -> Python scalars. A tensor, on any device, crosses to
    the host through ``device.to_host`` first and is then encoded as the
    ndarray it becomes (same dtype string, same shape)."""
    if isinstance(value, torch.Tensor):
        value = to_host(value)
    if isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        return {"__nd__": [arr.dtype.str, list(arr.shape),
                           base64.b64encode(arr.tobytes()).decode("ascii")]}
    if isinstance(value, tuple):
        return {"__tup__": [encode_value(v) for v in value]}
    if isinstance(value, list):
        return [encode_value(v) for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


def decode_value(enc) -> object:
    """Inverse of :func:`encode_value` (byte-identical arrays)."""
    if isinstance(enc, dict) and "__nd__" in enc:
        dtype_str, shape, b64 = enc["__nd__"]
        data = base64.b64decode(b64.encode("ascii"))
        return np.frombuffer(data, dtype=np.dtype(dtype_str)).reshape(shape)
    if isinstance(enc, dict) and "__tup__" in enc:
        return tuple(decode_value(v) for v in enc["__tup__"])
    if isinstance(enc, list):
        return [decode_value(v) for v in enc]
    return enc


def encode_query(q: Query) -> dict:
    from repro_torch.graph.query import query_kind
    return {"kind": query_kind(q), "query": dataclasses.asdict(q)}


def decode_query(kind: str, fields: dict) -> Query:
    """Raises ``ValueError``/``TypeError`` on an unknown kind or malformed
    fields — the listener maps either to an ``ERR_BAD_QUERY`` response."""
    cls = _QUERY_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown query kind {kind!r}")
    return cls(**fields)


def encode_response(resp: QueryResponse) -> dict:
    out = {"id": resp.request_id, "ok": resp.ok,
           "latency_s": resp.latency_s}
    if resp.ok:
        out["value"] = encode_value(resp.value)
        out["version"] = resp.version.pack() if resp.version else None
        if resp.degraded:
            # only when set: peers without a durable store never send the
            # key, so absence stays the healthy default on both ends of
            # the wire
            out["degraded"] = True
    else:
        out["error"] = {"code": resp.error.code,
                        "message": resp.error.message}
    return out


def decode_response(frame: dict) -> QueryResponse:
    if frame["ok"]:
        packed = frame.get("version")
        return QueryResponse.answered(
            frame["id"], decode_value(frame["value"]),
            Version.unpack(packed) if packed is not None else None,
            frame["latency_s"], degraded=frame.get("degraded", False))
    err = frame["error"]
    return QueryResponse.failed(frame["id"], err["code"],
                                err.get("message", ""),
                                latency_s=frame["latency_s"])


# ------------------------------------------------------------- server
class GraphRPCServer:
    """TCP front over one :class:`GraphQueryServer` (see module docs for
    the wire format and threading model). ``start()`` binds and spins up
    the accept + dispatcher threads; :attr:`address` is the bound
    ``(host, port)`` — bind ``port=0`` for an ephemeral port. ``stop()``
    closes the listener and every live connection and joins the
    threads."""

    def __init__(self, server: GraphQueryServer, *,
                 host: str = "127.0.0.1", port: int = 0,
                 backlog: int = 64, batch_wait_s: float = 0.002):
        self.server = server
        self.host = host
        self.port = port
        self.backlog = backlog
        # scheduler batching window: after the first request wakes the
        # dispatcher, wait this long before running the window so
        # concurrently-arriving clients collapse into one vectorized call
        # instead of a string of size-1 windows (latency cost: one
        # batch_wait per round trip, amortized across every rider)
        self.batch_wait_s = batch_wait_s
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # guards the live-connection set (reader threads add/remove
        # themselves; stop() snapshots it to close stragglers)
        self._conn_lock = threading.Lock()
        self._conns: set[socket.socket] = set()

    @property
    def address(self) -> tuple[str, int]:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[:2]

    def start(self) -> "GraphRPCServer":
        sock = socket.create_server((self.host, self.port),
                                    backlog=self.backlog, reuse_port=False)
        sock.settimeout(0.2)        # so the accept loop notices stop()
        self._sock = sock
        threads = [("rpc-accept", self._accept_loop, ())]
        if self.server.two_lane:
            # one dispatcher per scheduler lane: the cheap dispatcher
            # keeps draining dict-lookup/one-sweep windows while the
            # expensive dispatcher works through PageRank convoys in
            # budgeted slices — the lanes share the engine, not the queue
            threads += [
                ("rpc-dispatch-cheap", self._dispatch_loop,
                 ("cheap", self.server.work_cheap)),
                ("rpc-dispatch-exp", self._dispatch_loop,
                 ("expensive", self.server.work_expensive))]
        else:
            threads += [("rpc-dispatch", self._dispatch_loop,
                         (None, self.server.work_available))]
        for name, target, args in threads:
            t = threading.Thread(target=target, args=args, daemon=True,
                                 name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # wake every dispatcher flavor
        self.server.work_available.set()
        self.server.work_cheap.set()
        self.server.work_expensive.set()
        self.server.stop_prewarm()
        if self._sock is not None:
            self._sock.close()
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- threads ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return              # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="rpc-conn")
            t.start()
            self._threads.append(t)

    def _dispatch_loop(self, lane=None, work=None) -> None:
        """A thread that runs query windows for every connection — this
        is where cross-client batching happens: all requests queued on
        this dispatcher's lane since its last window (no matter which
        reader enqueued them) execute as one scheduler window. With
        ``two_lane`` there are two of these — one per lane, each waiting
        on its own wake event — so cheap windows never queue behind an
        expensive window's compute; a single-queue server gets one
        dispatcher (``lane=None``) for every kind."""
        if work is None:
            work = self.server.work_available
        while not self._stop.is_set():
            if not work.wait(timeout=0.2):
                continue
            if self.batch_wait_s:
                time.sleep(self.batch_wait_s)   # let a batch accumulate
            work.clear()
            try:
                self.server.run_window(lane)
            except Exception:
                # all-or-nothing window: everything undelivered was
                # re-queued (e.g. nothing sealed yet) — retry shortly
                time.sleep(0.005)
                work.set()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()   # per-connection: frames atomic

        def reply(frame: dict) -> None:
            data = encode_frame(frame)
            try:
                with send_lock:
                    conn.sendall(data)
            except OSError:
                pass               # peer went away; reader will notice

        try:
            while not self._stop.is_set():
                try:
                    frame = read_frame(conn)
                except (ConnectionError, ValueError, OSError):
                    break
                if frame is None:
                    break
                self._handle(frame, reply)
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            conn.close()

    def _handle(self, frame: dict, reply) -> None:
        rid = frame.get("id", 0)
        op = frame.get("op")
        if op == "stats":
            s = self.server.stats()
            enc = {k: encode_value(v) for k, v in
                   dataclasses.asdict(s).items()}
            v = s.serving_version
            enc["serving_version"] = v.pack() if v is not None else None
            reply({"id": rid, "ok": True, "latency_s": 0.0, "value": enc})
            return
        if op != "query":
            reply(encode_response(QueryResponse.failed(
                rid, ERR_BAD_QUERY, f"unknown op {op!r}")))
            return
        try:
            query = decode_query(frame.get("kind"),
                                 frame.get("query") or {})
            pin = frame.get("pin")
            request = QueryRequest(
                query=query, request_id=rid,
                pin_version=(Version.unpack(pin)
                             if pin is not None else None),
                deadline_s=frame.get("deadline_s"))
        except (TypeError, ValueError, KeyError) as exc:
            reply(encode_response(QueryResponse.failed(
                rid, ERR_BAD_QUERY, str(exc))))
            return
        shed = self.server.submit_request(
            request, on_done=lambda resp: reply(encode_response(resp)))
        if shed is not None:       # typed overload/bad-query: answer NOW
            reply(encode_response(shed))


# ------------------------------------------------------------- client
class GraphRPCClient:
    """Blocking client for the wire protocol. One TCP connection; NOT
    thread-safe (give each client thread its own instance — that is
    exactly what the soak test and benchmark do).

    :meth:`query` is the synchronous round trip, with bounded
    exponential-backoff-with-jitter retry over two transient failure
    classes: a typed ``ERR_OVERLOADED`` shed, and transport faults
    (connect refused, EOF/reset mid-round-trip, socket timeout) — the
    latter reconnect before retrying. Retries honor ``deadline_s`` as a
    total budget: the client never sleeps past the deadline, and when it
    gives up it surfaces the ORIGINAL typed response (or re-raises the
    transport error when there was none). Non-retryable typed errors
    (``ERR_BAD_QUERY``, ``ERR_BAD_PIN``, ``ERR_DEADLINE``, ...) return
    immediately. Retried queries are at-least-once: a transport fault
    after the server executed but before the response landed replays the
    request — safe here because every query is a read at a sealed
    snapshot.

    :meth:`send`/:meth:`recv` expose the raw pipelined half-steps (no
    retry — a pipeliner owns its own in-flight bookkeeping): keep several
    requests in flight on one connection and collect responses (matched
    by ``request_id``; the server may answer out of submission order
    across windows)."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: Optional[float] = 30.0,
                 max_retries: int = 5, retry_base_s: float = 0.01,
                 retry_cap_s: float = 0.5,
                 jitter: Optional[Callable[[], float]] = None):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        # jitter source in [0, 1); injectable so the retry tests pin the
        # sleep schedule deterministically
        self._jitter = random.random if jitter is None else jitter
        self._sock: Optional[socket.socket] = None
        self._next_id = 1
        self._connect()

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based): exponential from
        ``retry_base_s``, capped at ``retry_cap_s``, half-jittered into
        ``[b/2, b]`` so a thundering herd of shed clients decorrelates
        without ever retrying immediately."""
        b = min(self.retry_cap_s, self.retry_base_s * (2.0 ** attempt))
        return b * (0.5 + 0.5 * self._jitter())

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "GraphRPCClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def send(self, q: Query, *, pin_version: Optional[Version] = None,
             deadline_s: Optional[float] = None,
             request_id: Union[int, str, None] = None) -> Union[int, str]:
        """Frame one query request onto the wire (no wait, no retry).
        Returns the request id the response will carry. Reconnects first
        if a previous transport fault dropped the connection."""
        if self._sock is None:
            self._connect()
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        frame = {"op": "query", "id": request_id, **encode_query(q),
                 "pin": pin_version.pack() if pin_version else None,
                 "deadline_s": deadline_s}
        self._sock.sendall(encode_frame(frame))
        return request_id

    def recv(self) -> QueryResponse:
        """Block for the next response frame on this connection."""
        if self._sock is None:
            raise ConnectionError("not connected")
        frame = read_frame(self._sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        return decode_response(frame)

    def query(self, q: Query, *, pin_version: Optional[Version] = None,
              deadline_s: Optional[float] = None) -> QueryResponse:
        """One synchronous query round trip (single request in flight, so
        the next response is necessarily ours), retried per the class
        docs. ``deadline_s`` is the TOTAL budget across retries; each
        attempt ships the remaining budget so the server's own deadline
        shedding stays consistent with the client's."""
        deadline_at = (time.monotonic() + deadline_s
                       if deadline_s is not None else None)
        shed: Optional[QueryResponse] = None
        error: Optional[OSError] = None
        for attempt in range(self.max_retries + 1):
            budget = deadline_s
            if deadline_at is not None:
                budget = max(0.0, deadline_at - time.monotonic())
            try:
                self.send(q, pin_version=pin_version, deadline_s=budget)
                resp = self.recv()
            except (ConnectionError, OSError) as exc:
                self._drop()        # reconnect lazily on the next attempt
                error = exc
            else:
                if resp.ok or resp.error.code != ERR_OVERLOADED:
                    return resp
                shed, error = resp, None
            if attempt >= self.max_retries:
                break
            delay = self._backoff(attempt)
            if deadline_at is not None and \
                    time.monotonic() + delay > deadline_at:
                break               # never sleep past the deadline
            time.sleep(delay)
        if shed is not None:
            return shed             # the original typed response
        raise error

    def stats(self) -> dict:
        """Server stats snapshot (``ServerStats`` fields as a dict;
        ``serving_version`` as a packed int or None)."""
        if self._sock is None:
            self._connect()
        self._sock.sendall(encode_frame({"op": "stats",
                                         "id": self._next_id}))
        self._next_id += 1
        frame = read_frame(self._sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        return decode_value(frame["value"])
