"""The durable graph plane in the port against the JAX reference: the WAL
record framing and the committed fixture corpus, rotation and GC,
crash-atomic checkpoints, recovery equal to an uncrashed store at every
version (across split and merge cutovers, and across the packages: a
WAL written by either is recovered by the other), seal faults and the
degraded server, and the retrying RPC client on the port's own scripted
transport. Every case runs both packages (the port on the CPU) on the
same seeded streams; WAL segment files, plan histories and views are
byte-identical. The cases mirror ``tests/test_recovery.py``.
"""
import os
import pathlib
import shutil
import socket
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_stores_same, assert_views_same,  # noqa: E402
                           both_streams, host)

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import compute as rgc  # noqa: E402
from repro.graph import sharded as rsh  # noqa: E402
from repro.graph import wal as rwal  # noqa: E402
from repro.graph.query import KHop, QueryRequest, QueryResponse  # noqa: E402
from repro.launch import rpc as rrpc  # noqa: E402
from repro.launch.serve_graph import GraphQueryServer as RServer  # noqa: E402
from repro_torch.core.versioned import Version as TV  # noqa: E402
from repro_torch.graph import query as tq  # noqa: E402
from repro_torch.graph import sharded as tsh  # noqa: E402
from repro_torch.graph import wal as twal  # noqa: E402
from repro_torch.launch import rpc as trpc  # noqa: E402
from repro_torch.launch.serve_graph import GraphQueryServer as TServer  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "wal_fixtures"
PKGS = {"port": (tsh.ShardedDynamicGraph, twal, {"device": "cpu"}),
        "ref": (rsh.ShardedDynamicGraph, rwal, {})}


def _streams(n, epochs, adds, seed=13):
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, adds,
                          seed=seed, delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in rb) * 2 + 64
    return tb, rb, e_max


def _store(pkg, *args, **kw):
    cls, _, extra = PKGS[pkg]
    return cls(*args, **kw, **extra)


def _recover(pkg, wal_dir, **kw):
    cls, _, extra = PKGS[pkg]
    return cls.recover(wal_dir, **kw, **extra)


def _wal_files(root) -> dict:
    """Every WAL segment and the control log under ``root``, by relative
    path, as bytes (checkpoints left out: ``.npz`` zips carry times)."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.wal"))}


def _assert_shards_same(a, b) -> None:
    """Per-shard arrays (not only views) byte-identical."""
    assert len(a.shards) == len(b.shards)
    for sa, sb in zip(a.shards, b.shards):
        e = sb.n_edges
        assert sa.n_edges == e
        for f in ("src", "dst", "created", "deleted"):
            assert getattr(sa, f)[:e].tobytes() == getattr(sb, f)[:e].tobytes()
        assert sa.v_created.tobytes() == sb.v_created.tobytes()


# ------------------------------------------------------------ WAL framing
def test_record_codec_round_trips_byte_identical(tmp_path):
    """Both packages frame the same rows into the same bytes, and each
    scans the other's record back to the same rows."""
    rng = np.random.default_rng(7)
    for n in (0, 1, 17, 256):
        rows = rng.integers(-(2**31), 2**31 - 1, size=(n, 4),
                            dtype=np.int64).astype(np.int32)
        packed = TV(int(rng.integers(0, 1000)), 0).pack()
        framed = twal.encode_record(packed, twal.rows_to_body(rows))
        assert framed == rwal.encode_record(packed, rwal.rows_to_body(rows))
        path = tmp_path / f"r{n}.wal"
        path.write_bytes(framed)
        [(got_packed, body, off)], clean = twal.scan_segment(path)
        assert (got_packed, off, clean) == (packed, 0, len(framed))
        assert twal.body_to_rows(body, path, 0).tobytes() == rows.tobytes()
        assert rwal.scan_segment(path)[0][0][1] == body


def test_fixture_corpus_regenerates_with_the_port(tmp_path):
    """The committed fixtures are exactly what the generator emits with
    the port's framing in place of the reference's."""
    sys.path.insert(0, str(FIXTURES))
    try:
        import make_fixtures as mf
    finally:
        sys.path.pop(0)
    saved = (mf.encode_record, mf.rows_to_body, mf.Version)
    mf.encode_record, mf.rows_to_body, mf.Version = (
        twal.encode_record, twal.rows_to_body, TV)
    try:
        fresh = mf.write_fixtures(tmp_path)
    finally:
        mf.encode_record, mf.rows_to_body, mf.Version = saved
    assert fresh
    for name, data in fresh.items():
        assert (FIXTURES / name).read_bytes() == data, name


def _scan(wal, name, **kw):
    """(epochs, bodies, clean offset) of a fixture, or the typed error as
    (message, segment name, offset)."""
    try:
        records, clean = wal.scan_segment(FIXTURES / name, **kw)
    except wal.WalCorruptionError as err:
        return (str(err).replace(str(FIXTURES), ""),
                pathlib.Path(err.segment).name, err.offset)
    return ([RV.unpack(p).epoch for p, _, _ in records],
            [b for _, b, _ in records], clean)


@pytest.mark.parametrize("name,kw,expect", [
    ("interleaved.wal", {}, "clean"),
    ("torn_tail.wal", {}, "torn WAL tail"),
    ("truncated_prefix.wal", {}, "dropping 7 bytes"),
    ("truncated_prefix.wal", {"tail_ok": False}, "trailing bytes"),
    ("bad_crc.wal", {}, "CRC mismatch"),
    ("bad_length.wal", {}, "length prefix"),
])
def test_fixture_scans_like_reference(name, kw, expect):
    """The port's scanner reads every committed fixture as the
    reference's does: clean scans, torn tails truncated with a warning,
    and typed corruption naming the segment and byte offset."""
    if expect == "clean":
        got, want = _scan(twal, name, **kw), _scan(rwal, name, **kw)
        assert got[0] == [0, 1, 2, 3] and got[1][2] == b""
        assert got[2] == (FIXTURES / name).stat().st_size
    elif expect in ("torn WAL tail", "dropping 7 bytes"):
        with pytest.warns(UserWarning, match=expect):
            got = _scan(twal, name, **kw)
        with pytest.warns(UserWarning, match=expect):
            want = _scan(rwal, name, **kw)
    else:
        got, want = _scan(twal, name, **kw), _scan(rwal, name, **kw)
        assert isinstance(got[0], str) and expect in got[0]
        assert got[1] == name
        if name != "truncated_prefix.wal":
            assert got[2] == 96 and f"@ byte {got[2]}" in got[0]
    assert got == want


def test_torn_shard_segment_scans_its_intact_epochs(tmp_path):
    """A torn fixture as a shard's segment: the torn record is not an
    epoch yet, in both packages."""
    d = tmp_path / "shard"
    d.mkdir()
    shutil.copy(FIXTURES / "torn_tail.wal", d / "seg-00000000.wal")
    with pytest.warns(UserWarning, match="torn WAL tail"):
        got = twal.scan_shard_records(d)
    with pytest.warns(UserWarning, match="torn WAL tail"):
        want = rwal.scan_shard_records(d)
    assert sorted(got) == sorted(want) == [0, 1]


def test_shard_wal_rotation_gc_and_truncation(tmp_path):
    """Appends, a rotation, segment GC below a checkpoint and truncation
    after a recovered epoch leave the same files, byte for byte."""
    out = {}
    for pkg, wal in (("port", twal), ("ref", rwal)):
        d = tmp_path / pkg
        w = wal.ShardWal(d, 0, fsync="never")
        for e in range(3):
            w.append(e, np.full((2, 4), e, np.int32))
        w.rotate(3)
        for e in range(3, 6):
            w.append(e, np.full((2, 4), e, np.int32))
        w.close()
        steps = [[p.name for p in w.segments()],
                 sorted(wal.scan_shard_records(d))]
        steps.append(w.drop_segments_below(3))
        steps.append(sorted(wal.scan_shard_records(d)))
        steps.append(wal.truncate_shard_after(d, 4))
        steps.append(sorted(wal.scan_shard_records(d)))
        steps.append(wal.truncate_shard_after(d, 4))
        out[pkg] = (steps, _wal_files(d))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [["seg-00000000.wal", "seg-00000003.wal"],
                              list(range(6)), 1, [3, 4, 5], 1, [3, 4], 0]


# --------------------------------------------------- checkpoint atomicity
@pytest.mark.parametrize("victim", ["ckpt_", "MANIFEST.json"])
def test_interrupted_checkpoint_save_keeps_previous(tmp_path, monkeypatch,
                                                    victim):
    """A save killed at either ``os.replace`` leaves the previous graph
    checkpoint loadable; both packages' checkpoints of the same store
    hold the same arrays, and each loads the other's."""
    tb, rb, e_max = _streams(64, 4, 40)
    loaded = {}
    for pkg, bs in (("port", tb), ("ref", rb)):
        _, wal, _ = PKGS[pkg]
        sg = _store(pkg, 2, 64, e_max)
        for b in bs[:2]:
            sg.apply(b)
        d = tmp_path / pkg
        mgr = wal.GraphCheckpointManager(d, keep=3)
        mgr.save_graph(sg, epoch=1)
        before = wal.GraphCheckpointManager(d, keep=3).load_graph()
        for b in bs[2:]:
            sg.apply(b)
        real = os.replace

        def boom(src, dst, *a, **kw):
            if victim in pathlib.Path(dst).name:
                raise OSError("simulated crash mid-save")
            return real(src, dst, *a, **kw)

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError, match="simulated crash"):
            mgr.save_graph(sg, epoch=3)
        monkeypatch.setattr(os, "replace", real)
        got = wal.GraphCheckpointManager(d, keep=3).load_graph()
        assert got["epoch"] == 1
        for k, arr in got["shards"][0].items():
            assert np.array_equal(arr, before["shards"][0][k]), k
        loaded[pkg] = got
    assert loaded["port"]["meta"] == loaded["ref"]["meta"]
    for sp, sr in zip(loaded["port"]["shards"], loaded["ref"]["shards"]):
        assert sorted(sp) == sorted(sr)
        for k in sp:
            assert sp[k].dtype == sr[k].dtype
            assert sp[k].tobytes() == sr[k].tobytes(), k
    cross = twal.GraphCheckpointManager(tmp_path / "ref", keep=3).load_graph()
    assert cross["meta"] == loaded["ref"]["meta"]


# ------------------------------------------------- crash recovery: oracle
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("checkpoint_every", [0, 3])
def test_recover_equals_reference_at_every_version(tmp_path, n_shards,
                                                   checkpoint_every):
    """Both packages write byte-identical WALs for the same stream; each
    recovers to the durable frontier with views equal to the uncrashed
    reference store's at every version, and keeps ingesting alike."""
    n, epochs = 96, 10
    tb, rb, e_max = _streams(n, epochs, 50)
    stores, recs = {}, {}
    for pkg, bs in (("port", tb), ("ref", rb)):
        sg = _store(pkg, n_shards, n, e_max, wal_dir=tmp_path / pkg,
                    wal_fsync="always", checkpoint_every=checkpoint_every)
        for b in bs[:8]:
            sg.apply(b)
        stores[pkg] = sg
        recs[pkg] = _recover(pkg, tmp_path / pkg)
        assert recs[pkg].coordinator.global_frontier == 7
    assert _wal_files(tmp_path / "port") == _wal_files(tmp_path / "ref")
    oracle = _store("ref", n_shards, n, e_max)
    for b in rb[:8]:
        oracle.apply(b)
    assert_stores_same(recs["port"], oracle, range(8))
    assert_stores_same(recs["port"], recs["ref"], range(8))
    _assert_shards_same(recs["port"], oracle)
    assert recs["port"].latest_sealed().pack() == oracle.latest_sealed().pack()
    for t, r in zip(tb[8:], rb[8:]):
        recs["port"].apply(t)
        oracle.apply(r)
    assert_stores_same(recs["port"], oracle, range(epochs))
    del stores


def _split_merge_run(pkg, bs, wal_dir, e_max, n):
    """The stream of ``test_recover_across_split_and_merge_cutovers``
    into a WAL-backed store of ``pkg``: a split after epoch 2, a merge of
    the pair after epoch 5."""
    sg = _store(pkg, 2, n, e_max, wal_dir=wal_dir, wal_fsync="always",
                checkpoint_every=4)
    for b in bs[:3]:
        sg.apply(b)
    sg.split_shard(0)
    for b in bs[3:6]:
        sg.apply(b)
    sg.merge_shards(2)
    for b in bs[6:]:
        sg.apply(b)
    return sg


def test_recover_across_split_and_merge_cutovers(tmp_path):
    """Recovery across a split and a merge cutover: plan history, retired
    set, frontier, per-shard arrays and every view equal the uncrashed
    reference store's; WALs and recovered stores agree across the
    packages, and the recovered port store keeps ingesting alike."""
    n, epochs = 96, 9
    tb, rb, e_max = _streams(n, epochs, 60, seed=5)
    oracle = _split_merge_run("ref", rb, None, e_max, n)
    writers = {pkg: _split_merge_run(pkg, bs, tmp_path / pkg, e_max, n)
               for pkg, bs in (("port", tb), ("ref", rb))}
    assert _wal_files(tmp_path / "port") == _wal_files(tmp_path / "ref")
    rec = _recover("port", tmp_path / "port")
    assert rec.plan.history == oracle.plan.history
    assert rec.retired == oracle.retired
    assert rec.migrations == oracle.migrations
    assert rec.coordinator.global_frontier == epochs - 1
    assert_stores_same(rec, oracle, range(epochs))
    _assert_shards_same(rec, oracle)
    tmore, rmore, _ = _streams(n, epochs + 2, 60, seed=5)
    for t, r in zip(tmore[epochs:], rmore[epochs:]):
        rec.apply(t)
        oracle.apply(r)
    assert_stores_same(rec, oracle, range(epochs + 2))
    del writers


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_split_merge_wal_recovers_across_packages(tmp_path, writer):
    """A WAL with a split and a merge, written by one package, is
    recovered by the other: the same plan history, retired set, stamps
    and views as the writer's own recovery."""
    n, epochs = 96, 9
    tb, rb, e_max = _streams(n, epochs, 60, seed=5)
    bs = tb if writer == "port" else rb
    w = _split_merge_run(writer, bs, tmp_path, e_max, n)
    w.wal.sync()
    reader = "ref" if writer == "port" else "port"
    other = _recover(reader, tmp_path)
    own_dir = tmp_path.parent / f"{tmp_path.name}_own"
    shutil.copytree(tmp_path, own_dir)
    own = _recover(writer, own_dir)
    assert other.plan.history == own.plan.history
    assert other.retired == own.retired
    assert other.coordinator.global_frontier == \
        own.coordinator.global_frontier == epochs - 1
    _assert_shards_same(other, own)
    port, ref = (other, own) if reader == "port" else (own, other)
    assert_stores_same(port, ref, range(epochs))
    # the reader's log after recovery is the writer's (nothing truncated)
    assert _wal_files(tmp_path) == _wal_files(own_dir)


def test_batch_fsync_crash_recovers_at_durable_frontier(tmp_path):
    """Batched fsync: the port recovers at a durable frontier within the
    checkpoint ladder, a second recovery is a no-op replay, and the
    re-driven tail converges with the reference store."""
    n, epochs = 96, 10
    tb, rb, e_max = _streams(n, epochs, 50, seed=3)
    sg = _store("port", 2, n, e_max, wal_dir=tmp_path, wal_fsync="batch",
                wal_fsync_every=64, checkpoint_every=4)
    for b in tb:
        sg.apply(b)
    rec = _recover("port", tmp_path)
    frontier = rec.coordinator.global_frontier
    assert 7 <= frontier <= epochs - 1
    assert _recover("port", tmp_path).coordinator.global_frontier == frontier
    # the reference reads the truncated log to the same frontier
    assert _recover("ref", tmp_path).coordinator.global_frontier == frontier
    oracle = _store("ref", 2, n, e_max)
    for b in rb:
        oracle.apply(b)
    assert_stores_same(rec, oracle, range(frontier + 1))
    for b in tb[frontier + 1:]:
        rec.apply(b)
    assert_stores_same(rec, oracle, range(epochs))
    del sg


@pytest.mark.parametrize("damage", ["torn_tail", "flipped_body"])
def test_recover_damaged_shard_segment(tmp_path, damage):
    """A torn shard tail is truncated with a warning (full frontier,
    views equal to the reference store's); a flipped body byte is the
    same typed corruption in both packages."""
    n = 64
    epochs = 6 if damage == "torn_tail" else 5
    tb, rb, e_max = _streams(n, epochs, 40, seed=9)
    sg = _store("port", 2, n, e_max, wal_dir=tmp_path, wal_fsync="always")
    for b in tb:
        sg.apply(b)
    if damage == "torn_tail":
        seg = sorted(twal.GraphWal.shard_dir(tmp_path, 0)
                     .glob("seg-*.wal"))[-1]
        with open(seg, "ab") as f:
            f.write(b"\x00\x01\x02\x03\x04\x05\x06")
        with pytest.warns(UserWarning, match="torn WAL tail"):
            rec = _recover("port", tmp_path)
        assert rec.coordinator.global_frontier == 5
        oracle = _store("ref", 2, n, e_max)
        for b in rb:
            oracle.apply(b)
        assert_stores_same(rec, oracle, range(epochs))
    else:
        seg = sorted(twal.GraphWal.shard_dir(tmp_path, 1)
                     .glob("seg-*.wal"))[0]
        data = bytearray(seg.read_bytes())
        data[20] ^= 0xFF
        seg.write_bytes(bytes(data))
        errs = []
        for pkg in ("port", "ref"):
            with pytest.raises(PKGS[pkg][1].WalCorruptionError,
                               match="CRC mismatch") as ei:
                _recover(pkg, tmp_path)
            errs.append((str(ei.value), ei.value.offset))
        assert errs[0] == errs[1] and errs[0][0].find(seg.name) >= 0
    del sg


def test_payload_reencode_is_replay_stable():
    """Encoded payload rows are the same bytes in both packages, and each
    package's decode and re-encode is the identity on them."""
    tb, rb, _ = _streams(48, 3, 30, seed=21)
    for t, r in zip(tb, rb):
        rows = rsh.encode_payload_rows(r)
        assert tsh.encode_payload_rows(t).tobytes() == rows.tobytes()
        [back] = tsh.decode_payloads([rows])
        assert tsh.encode_payload_rows(back).tobytes() == rows.tobytes()


# -------------------------------------------------------- degraded serving
def _served(pkg, bs, e_max, n=128, epochs=3, **kw):
    _, wal, _ = PKGS[pkg]
    inj = wal.FaultInjector()
    sg = _store(pkg, 2, n, e_max, fault_injector=inj, **kw)
    Server = TServer if pkg == "port" else RServer
    srv = Server(sg, auto_reshard=False, prewarm_traces=False)
    for b in bs[:epochs]:
        srv.step(b)
    return srv, sg, inj


def test_fault_injector_kills_seal_cleanly_and_reseals():
    """A one-shot fault fails the seal with the same typed error, holds
    the frontier, and the re-seal works, in both packages; the views
    after it agree."""
    tb, rb, e_max = _streams(128, 7, 60, seed=11)
    got = []
    for pkg, bs in (("port", tb), ("ref", rb)):
        srv, sg, inj = _served(pkg, bs, e_max)
        inj.fail(1)
        sg.ingest(bs[3])
        with pytest.raises(PKGS[pkg][1].ShardFaultError,
                           match="shard 1") as ei:
            sg.seal_epoch(3)
        got.append((str(ei.value), inj.faults_fired,
                    sg.coordinator.global_frontier, sg.seal_epoch(3)))
        got.append(sg)
    assert got[0] == got[2]
    assert got[0][1:] == (1, 2, 3)
    assert_stores_same(got[1], got[3], range(4))


def test_server_degrades_and_catches_up_matching_reference():
    """A dropped shard degrades both servers alike (held snapshot, the
    degraded hint, the same counters); after heal they catch up to the
    same version and answer like the reference's compute on the oracle."""
    tb, rb, e_max = _streams(128, 7, 60, seed=11)
    out = {}
    for pkg, bs in (("port", tb), ("ref", rb)):
        srv, sg, inj = _served(pkg, bs, e_max)
        Q = tq.KHop if pkg == "port" else KHop
        Req = tq.QueryRequest if pkg == "port" else QueryRequest
        steps = [srv.query(Q(5, k=1)).version.epoch]
        inj.drop(1)
        srv.step(bs[3])
        srv.step(bs[4])
        s = srv.stats()
        steps.append((s.degraded, s.seal_failures, s.stale_epochs))
        steps.append(srv.query(Q(5, k=1)).version.epoch)
        got, done = {}, threading.Event()
        srv.submit_request(Req(query=Q(5, k=1), request_id="x"),
                           on_done=lambda r: (got.update(r=r), done.set()))
        srv.run_window()
        assert done.wait(1.0)
        steps.append(got["r"].degraded)
        inj.heal()
        steps.append(srv.reseal())
        s = srv.stats()
        steps.append((s.degraded, s.stale_epochs, s.seal_failures))
        r = srv.query(Q(9, k=2))
        steps.append(r.version.epoch)
        out[pkg] = (steps, host(r.value))
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0] == [2, (True, 2, 2), 2, True, 4, (False, 0, 2), 4]
    assert out["port"][1].tobytes() == out["ref"][1].tobytes()
    oracle = _store("ref", 2, 128, 100_000)
    for b in rb[:5]:
        oracle.apply(b)
    want = np.asarray(rgc.k_hop(oracle.join_view(rb[4].version),
                                np.array([9]), 2))
    assert out["port"][1].tobytes() == want.tobytes()


def test_degraded_flag_round_trips_the_wire():
    """The degraded hint is the same frame field in both packages, absent
    when healthy, and decodes across them."""
    for degraded in (True, False):
        tresp = tq.QueryResponse.answered(1, np.arange(3), TV(2, 0), 0.1,
                                          degraded=degraded)
        frame = trpc.encode_response(tresp)
        assert ("degraded" in frame) is degraded
        rresp = QueryResponse.answered(1, np.arange(3), RV(2, 0), 0.1,
                                       degraded=degraded)
        assert trpc.encode_frame(frame) == \
            rrpc.encode_frame(rrpc.encode_response(rresp))
        assert rrpc.decode_response(frame).degraded is degraded
        assert trpc.decode_response(frame).degraded is degraded


# ------------------------------------------------------- RPC retry client
class _ScriptedFront:
    """Raw-socket stand-in for the RPC server built on the port's framing,
    answering each request per a fixed script: ``shed`` (typed
    overload), ``ok``, ``bad_query``, ``drop`` (close without a reply)."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = 0
        self.frames: list[dict] = []
        self._sock = socket.create_server(("127.0.0.1", 0))
        self._sock.settimeout(0.2)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    @property
    def address(self):
        return self._sock.getsockname()[:2]

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                self._serve(conn)

    def _serve(self, conn):
        while not self._stop.is_set():
            try:
                frame = trpc.read_frame(conn)
            except (ConnectionError, OSError):
                return
            if frame is None:
                return
            act = self.script[self.requests] \
                if self.requests < len(self.script) else "ok"
            self.requests += 1
            self.frames.append(frame)
            rid = frame.get("id", 0)
            if act == "drop":
                return
            if act == "shed":
                resp = tq.QueryResponse.failed(rid, tq.ERR_OVERLOADED, "shed")
            elif act == "bad_query":
                resp = tq.QueryResponse.failed(rid, tq.ERR_BAD_QUERY, "nope")
            else:
                resp = tq.QueryResponse.answered(rid, np.arange(3),
                                                 TV(1, 0), 0.0)
            try:
                conn.sendall(trpc.encode_frame(trpc.encode_response(resp)))
            except OSError:
                return

    def stop(self):
        self._stop.set()
        self._sock.close()
        self._t.join(timeout=2.0)


def _client_run(pkg, script, query_kw=None, **kw):
    """Drive one client of ``pkg`` against a scripted port front; returns
    (outcome, requests seen, frames seen, seconds)."""
    rpc = trpc if pkg == "port" else rrpc
    Q = tq.KHop if pkg == "port" else KHop
    front = _ScriptedFront(script)
    kw.setdefault("retry_base_s", 0.002)
    client = rpc.GraphRPCClient(*front.address, **kw)
    t0 = time.monotonic()
    try:
        r = client.query(Q(0, k=1), **(query_kw or {}))
        outcome = (r.ok, None if r.ok else r.error.code,
                   host(r.value).tolist() if r.ok else None)
    except (ConnectionError, OSError) as exc:
        outcome = ("raised", type(exc).__mro__[-3].__name__)
    finally:
        client.close()
        front.stop()
    return outcome, front.requests, front.frames, time.monotonic() - t0


def test_backoff_is_exponential_capped_and_half_jittered():
    """The backoff schedule is the reference's, with the jitter pinned to
    its floor and its ceiling."""
    for jit in (0.0, 1.0):
        tc = trpc.GraphRPCClient.__new__(trpc.GraphRPCClient)
        rc = rrpc.GraphRPCClient.__new__(rrpc.GraphRPCClient)
        for c in (tc, rc):
            c.retry_base_s, c.retry_cap_s = 0.002, 0.5
            c._jitter = lambda j=jit: j
        assert [tc._backoff(a) for a in range(40)] == \
            [rc._backoff(a) for a in range(40)]
        assert tc._backoff(0) == 0.002 * (0.5 if jit == 0.0 else 1.0)
        assert tc._backoff(30) == 0.5 * (0.5 if jit == 0.0 else 1.0)


@pytest.mark.parametrize("script,kw,query_kw,expect", [
    (["shed", "shed", "ok"], {"jitter": lambda: 1.0}, None,
     ((True, None, [0, 1, 2]), 3)),
    (["shed"] * 10, {"max_retries": 2, "jitter": lambda: 0.0}, None,
     ((False, "overloaded"), 3)),
    (["shed"] * 10, {"retry_base_s": 1.0, "max_retries": 5,
                     "jitter": lambda: 1.0}, {"deadline_s": 0.05},
     ((False, "overloaded"), 1)),
    (["bad_query", "ok"], {"jitter": lambda: 1.0}, None,
     ((False, "bad_query"), 1)),
    (["drop", "ok"], {"jitter": lambda: 0.0}, None,
     ((True, None, [0, 1, 2]), 2)),
    (["drop"] * 10, {"max_retries": 1, "jitter": lambda: 0.0}, None,
     (("raised",), 2)),
], ids=["overload_retried", "give_up_typed", "deadline_budget",
        "non_retryable", "eof_reconnects", "transport_exhaustion"])
def test_retrying_client_on_scripted_transport(script, kw, query_kw,
                                               expect):
    """The port's client and the reference's, each against the port's
    scripted front: retries of overloads and transport faults, give-up
    with the original typed error, the deadline as a total budget (the
    remaining budget shipped), no retry of a non-retryable error."""
    runs = {pkg: _client_run(pkg, script, query_kw, **dict(kw))
            for pkg in ("port", "ref")}
    (tout, treq, tframes, tsec), (rout, rreq, _, _) = runs["port"], \
        runs["ref"]
    assert (tout, treq) == (rout, rreq)
    want_out, want_req = expect
    assert treq == want_req
    if want_out[0] == "raised":
        assert tout[0] == "raised"
    elif want_out[0]:
        assert tout == want_out
    else:
        code = {"overloaded": tq.ERR_OVERLOADED,
                "bad_query": tq.ERR_BAD_QUERY}[want_out[1]]
        assert tout[:2] == (False, code)
    if query_kw:
        assert tsec < 0.5 and tframes[0]["deadline_s"] <= 0.05


# ------------------------------------------------------------- chaos soak
def _chaos(pkg, bs, e_max, wal_dir):
    n, epochs = 128, 10
    _, wal, _ = PKGS[pkg]
    inj = wal.FaultInjector()
    sg = _store(pkg, 2, n, e_max, wal_dir=wal_dir, wal_fsync="always",
                checkpoint_every=4, fault_injector=inj)
    Server = TServer if pkg == "port" else RServer
    srv = Server(sg, auto_reshard=False, prewarm_traces=False)
    rng = np.random.default_rng(17)
    for e, b in enumerate(bs):
        if e in (2, 7):
            inj.fail(int(rng.integers(0, 2)))
        if e == 4:
            inj.drop(1)
        if e == 6:
            inj.heal()
            srv.reseal()
        srv.step(b)
        if e < 4 or e >= 6:
            srv.reseal()
    srv.reseal()
    s = srv.stats()
    assert sg.coordinator.global_frontier == epochs - 1
    inj.heal()
    return sg, (s.seal_failures, s.degraded, inj.faults_fired)


@pytest.mark.chaos
def test_chaos_faults_wal_and_recovery_match_reference(tmp_path):
    """Seeded one-shot kills and a drop/heal outage while ingesting: both
    packages absorb the same faults, write the same WAL, end equal to the
    uncrashed reference store, and the port's recovery agrees too."""
    tb, rb, e_max = _streams(128, 10, 60, seed=17)
    tsg, tstat = _chaos("port", tb, e_max, tmp_path / "port")
    rsg, rstat = _chaos("ref", rb, e_max, tmp_path / "ref")
    assert tstat == rstat and tstat[0] >= 3 and not tstat[1]
    assert _wal_files(tmp_path / "port") == _wal_files(tmp_path / "ref")
    oracle = _store("ref", 2, 128, e_max)
    for b in rb:
        oracle.apply(b)
    assert_stores_same(tsg, oracle, range(10))
    rec = _recover("port", tmp_path / "port")
    assert_stores_same(rec, oracle, range(10))
    _assert_shards_same(rec, oracle)
    for b in tb:
        assert_views_same(rec.join_view(b.version), tsg.join_view(b.version),
                          str(b.version))
