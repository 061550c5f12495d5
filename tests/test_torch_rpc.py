"""The port's RPC tier (``launch/rpc.py``) against the JAX package's: the
same answers make the same frames, byte for byte (an answer held in a
tensor encodes as the ndarray it becomes on the host); a client of either
package talks to a server of the other and decodes the same answers; the
server sheds typed overloads, stops idempotently, and the port's
``serve_graph --rpc-port`` serves a stream until its stdin closes. Also
the CPU rehearsal of ``chip_smoke.py``'s phase 7.

Every test that touches a socket runs under its own time limit
(:func:`_bounded`), so none can hang the suite."""
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import load_chip_smoke, same_answer  # noqa: E402

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import query as rq  # noqa: E402
from repro.graph.dyngraph import synthesize_churn_stream as r_stream  # noqa: E402
from repro.graph.sharded import ShardedDynamicGraph as RSharded  # noqa: E402
from repro.launch import rpc as rrpc  # noqa: E402
from repro.launch import serve_graph as rsg  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import query as tq  # noqa: E402
from repro_torch.graph.dyngraph import synthesize_churn_stream as t_stream  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402
from repro_torch.launch import rpc as trpc  # noqa: E402
from repro_torch.launch import serve_graph as tsg  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, EPOCHS, ADDS, SHARDS, SEED = 64, 5, 60, 3, 13


def _bounded(fn, seconds: float = 60.0):
    """Run ``fn`` on a daemon thread; fail if it is not done in
    ``seconds`` (the thread is abandoned, the suite goes on)."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:   # handed to the test thread
            box["error"] = exc
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"timed out after {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _ref_server(**kw):
    batches = r_stream(N, EPOCHS, ADDS, seed=SEED, delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    return rsg.GraphQueryServer(RSharded(SHARDS, N, e_max), **kw), batches


def _port_server(**kw):
    batches = t_stream(N, EPOCHS, ADDS, seed=SEED, delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    return tsg.GraphQueryServer(TSharded(SHARDS, N, e_max, device="cpu"),
                                **kw), batches


# ------------------------------------------------------------------ codec
VALUES = [
    np.arange(17, dtype=np.int64),
    np.random.default_rng(0).random(33),            # float64 exact bits
    np.zeros((3, 5), np.float32),
    np.array([True, False, True]),
    (np.arange(4, dtype=np.int32), np.linspace(0, 1, 4)),
    (np.array([3, 1], np.int64), np.array([0.5, 0.25], np.float32)),
    [np.int32(3), np.float32(0.5), 7],
    np.float32(1.5),
    True,
    None,
]


@pytest.mark.parametrize("value", VALUES)
def test_value_codec_and_frames_equal_reference(value):
    enc = trpc.encode_value(value)
    assert enc == rrpc.encode_value(value)
    resp = {"id": 4, "ok": True, "latency_s": 0.25, "value": enc,
            "version": RV(3, 1).pack()}
    assert trpc.encode_frame(resp) == rrpc.encode_frame(resp)
    got = trpc.decode_value(enc)
    want = rrpc.decode_value(enc)
    assert same_answer(got, want) and type(got) is type(want)


@pytest.mark.parametrize("value", [v for v in VALUES
                                   if isinstance(v, (np.ndarray, tuple))])
def test_tensor_answers_encode_as_their_host_arrays(value):
    """A tensor encodes as the reference encodes the same ndarray: same
    dtype string, shape and bytes; tuples keep their tuple tag."""
    as_tensor = (tuple(torch.from_numpy(np.asarray(v)) for v in value)
                 if isinstance(value, tuple) else torch.from_numpy(value))
    assert trpc.encode_value(as_tensor) == rrpc.encode_value(value)


@pytest.mark.parametrize("q", [
    tq.KHop(source=5, k=2), tq.Reachability(src=1, dst=9, max_hops=4),
    tq.Reachability(src=1, dst=9), tq.DegreeTopK(7, direction="out"),
    tq.PageRankQuery(top_k=3), tq.PageRankQuery()])
def test_query_codec_equals_reference(q):
    enc = trpc.encode_query(q)
    rq_ = getattr(rq, type(q).__name__)(**q.__dict__)
    assert enc == rrpc.encode_query(rq_)
    assert trpc.decode_query(enc["kind"], enc["query"]) == q
    frame = {"op": "query", "id": 1, **enc, "pin": None, "deadline_s": None}
    assert trpc.encode_frame(frame) == rrpc.encode_frame(frame)


def test_codec_errors_and_responses_equal_reference():
    for mod in (trpc, rrpc):
        with pytest.raises(ValueError, match="unknown query kind"):
            mod.decode_query("bogus", {})
        with pytest.raises(TypeError):
            mod.decode_query("k_hop", {"nope": 1})
    ok = (tq.QueryResponse.answered(7, np.arange(5), TV(3, 1), 0.25),
          rq.QueryResponse.answered(7, np.arange(5), RV(3, 1), 0.25))
    err = (tq.QueryResponse.failed("abc", tq.ERR_DEADLINE, "too slow",
                                   latency_s=0.5),
           rq.QueryResponse.failed("abc", rq.ERR_DEADLINE, "too slow",
                                   latency_s=0.5))
    for t, r in (ok, err):
        assert trpc.encode_frame(trpc.encode_response(t)) == \
            rrpc.encode_frame(rrpc.encode_response(r))
    got = trpc.decode_response(trpc.encode_response(ok[0]))
    assert got.ok and got.version == TV(3, 1)
    assert got.value.tobytes() == np.arange(5).tobytes()


def test_frame_layer_length_prefix_and_eof():
    def run():
        a, b = socket.socketpair()
        a.settimeout(10)
        b.settimeout(10)
        try:
            frame = {"op": "query", "id": 1}
            a.sendall(trpc.encode_frame(frame))
            assert trpc.read_frame(b) == frame
            a.sendall(rrpc.encode_frame(frame)[:3])    # torn mid-frame
            a.close()
            with pytest.raises(ConnectionError, match="mid-frame"):
                trpc.read_frame(b)
        finally:
            b.close()
    _bounded(run, 30)


# ----------------------------------------------------- across the wire
QUERIES = [("KHop", {"source": 3, "k": 2}),
           ("Reachability", {"src": 1, "dst": 7, "max_hops": 6}),
           ("Reachability", {"src": 5, "dst": 2}),
           ("DegreeTopK", {"k": 5}),
           ("DegreeTopK", {"k": 4, "direction": "out"}),
           ("PageRankQuery", {"top_k": 4}),
           ("PageRankQuery", {})]


def _ask(client_mod, query_mod, host, port):
    out = []
    with client_mod.GraphRPCClient(host, port, timeout_s=30) as c:
        for name, fields in QUERIES:
            r = c.query(getattr(query_mod, name)(**fields))
            assert r.ok, r.error
            out.append((r.version.pack(), r.value))
        pinned = c.query(query_mod.KHop(source=3, k=2),
                         pin_version=type(r.version)(1, 0))
        assert pinned.ok and pinned.version.pack() == RV(1, 0).pack()
        out.append((pinned.version.pack(), pinned.value))
        out.append(c.stats()["served"])
    return out


def _same_answers(a, b):
    for (name, _), (va, xa), (vb, xb) in zip(QUERIES, a, b):
        assert va == vb
        if name == "PageRankQuery":
            ra = xa[1] if isinstance(xa, tuple) else xa
            rb = xb[1] if isinstance(xb, tuple) else xb
            np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-6)
        else:
            assert same_answer(xa, xb), name
    assert a[-2][0] == b[-2][0] and same_answer(a[-2][1], b[-2][1])


def test_clients_and_servers_of_both_packages_agree():
    """Reference client -> port server and port client -> reference server
    decode the same answers as each package's own pair; the non-PageRank
    answers' frames are byte-equal."""
    def run():
        fronts = []
        try:
            addrs = {}
            for name, make, rpc in (("ref", _ref_server, rrpc),
                                    ("port", _port_server, trpc)):
                server, batches = make()
                for b in batches:
                    server.step(b)
                front = rpc.GraphRPCServer(server, port=0).start()
                fronts.append(front)
                addrs[name] = front.address
            got = {}
            for client, cmod, qmod in (("ref", rrpc, rq), ("port", trpc, tq)):
                for server in ("ref", "port"):
                    got[client, server] = _ask(cmod, qmod, *addrs[server])
            _same_answers(got["ref", "port"], got["ref", "ref"])
            _same_answers(got["port", "ref"], got["port", "port"])
            _same_answers(got["port", "port"], got["ref", "ref"])
            for (name, _), (v, a), (_, b) in zip(QUERIES, got["ref", "port"],
                                                 got["ref", "ref"]):
                if name != "PageRankQuery":
                    ta = trpc.encode_response(tq.QueryResponse.answered(
                        1, a, TV.unpack(v), 0.5))
                    rb = rrpc.encode_response(rq.QueryResponse.answered(
                        1, b, RV.unpack(v), 0.5))
                    assert trpc.encode_frame(ta) == rrpc.encode_frame(rb)
        finally:
            for front in fronts:
                front.stop()
    _bounded(run, 120)


def test_rpc_overload_sheds_typed_response():
    def run():
        server, batches = _port_server(max_pending=0)   # every request sheds
        server.step(batches[0])
        front = trpc.GraphRPCServer(server, port=0).start()
        try:
            with rrpc.GraphRPCClient(*front.address, timeout_s=30,
                                     max_retries=2) as c:
                r = c.query(rq.KHop(source=0, k=1))
                assert not r.ok and r.error.code == rq.ERR_OVERLOADED
            assert server.stats().shed_overload == 3   # 1 try + 2 retries
        finally:
            front.stop()
    _bounded(run, 60)


def test_rpc_typed_wire_errors():
    def run():
        server, batches = _port_server()
        for b in batches:
            server.step(b)
        front = trpc.GraphRPCServer(server, port=0).start()
        try:
            with trpc.GraphRPCClient(*front.address, timeout_s=30) as c:
                c._sock.sendall(trpc.encode_frame(
                    {"op": "query", "id": 99, "kind": "bogus", "query": {}}))
                bad = c.recv()
                assert not bad.ok and bad.error.code == tq.ERR_BAD_QUERY
                c._sock.sendall(trpc.encode_frame({"op": "nope", "id": 100}))
                assert c.recv().error.code == tq.ERR_BAD_QUERY
                r = c.query(tq.KHop(3, 2), pin_version=TV(99, 0))
                assert not r.ok and r.error.code == tq.ERR_BAD_PIN
                s = c.stats()
                assert s["n_shards"] == SHARDS
                assert TV.unpack(s["serving_version"]) == \
                    TV(EPOCHS - 1, 0)
        finally:
            front.stop()
    _bounded(run, 60)


def test_rpc_stop_is_idempotent_and_releases_port():
    def run():
        server, batches = _port_server()
        server.step(batches[0])
        front = trpc.GraphRPCServer(server, port=0).start()
        host, port = front.address
        front.stop()
        front.stop()                            # second stop is a no-op
        with pytest.raises(OSError):
            socket.create_connection((host, port), timeout=0.5)
    _bounded(run, 30)


def test_serve_graph_rpc_mode_subprocess():
    """``python -m repro_torch.launch.serve_graph --device cpu --vertices 500
    --rpc-port 0``: announces its port, answers while and after the stream
    ingests, and stops when its stdin closes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_graph",
         "--device", "cpu", "--vertices", "500", "--rpc-port", "0",
         "--epochs", "4", "--adds-per-epoch", "400", "--shards", "2",
         "--ingest-delay-s", "0.01"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = _bounded(proc.stdout.readline, 120)
        m = re.match(r"RPC listening on (\S+):(\d+)", line)
        assert m, line
        host, port = m.group(1), int(m.group(2))

        def drive():
            with trpc.GraphRPCClient(host, port, timeout_s=30) as c:
                answers = [c.query(tq.KHop(source=i, k=2)) for i in range(4)]
                assert all(r.ok for r in answers)
                drained = proc.stdout.readline()
                assert drained.startswith("stream drained"), drained
                last = c.query(tq.DegreeTopK(k=3))
                assert last.ok and last.version == TV(3, 0)
                assert c.stats()["served"] == 5
        _bounded(drive, 120)
        proc.stdin.close()
        rest = _bounded(proc.stdout.read, 60)
        assert proc.wait(timeout=60) == 0
        assert re.search(r"served 5 queries over RPC on cpu", rest), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_chip_smoke_rpc_phase_rehearsal():
    """Phase 7 of chip_smoke.py on the CPU at a small size: socket clients
    while the stream ingests, every answer rechecked on the plain path at
    its version, then the sharded partitions in both placements."""
    cs = load_chip_smoke()

    def run():
        got = cs.serve_rpc(torch, "cpu", 1024, 3, 1000, 2, 12)
        try:
            sharded = cs.check_sharded_partitions(torch, got["graph"], 8)
        finally:
            got["graph"].shutdown()
        return got, sharded
    got, sharded = _bounded(run, 180)
    assert got["served"] == 24 and got["pinned"] > 0
    assert sum(got["kinds"].values()) == 24 and len(got["kinds"]) == 4
    assert sorted(sharded) == ["dst_hash/allgather", "src/hub",
                               "src/scatter"]
