"""The port's serving tier under everything at once, audited against the
JAX reference: RPC clients with randomized deadlines and pinned reads
hammer the port's two-lane front while the ingest thread streams churn
and performs a split and then a merge of the split pair, with stalls
injected into expensive windows. Typed errors are the only failure
surface, every client gets exactly its own responses back in order, and
every successful non-PageRank answer is byte-identical to the
reference's single-store replay at its served version. This is the
quick-scale soak of ``tests/test_soak.py``; the full-scale one is not
ported (it is a CI leg of its own).

Also the CPU rehearsal of ``chip_smoke.py``'s phase 13 (the elastic and
durable graph plane) at a small size, with its three planted faults.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (both_streams, host, load_chip_smoke,  # noqa: E402
                           port_query)

from repro.core.versioned import Version as RV  # noqa: E402
from repro.graph import compute as rgc  # noqa: E402
from repro.graph.dyngraph import DynamicGraph as RGraph  # noqa: E402
from repro.graph.query import (DegreeTopK, KHop, PageRankQuery,  # noqa: E402
                               Reachability)
from repro_torch.graph import query as tq  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph as TSharded  # noqa: E402
from repro_torch.launch import rpc as trpc  # noqa: E402
from repro_torch.launch.serve_graph import GraphQueryServer as TServer  # noqa: E402

TYPED_ERRORS = (tq.ERR_BAD_PIN, tq.ERR_DEADLINE, tq.ERR_OVERLOADED)


def _client_queries(ci: int, per_client: int, n: int):
    """The reference soak's per-client workload: (query, deadline_s,
    pin_slot) triples, regenerable for the audit."""
    rng = np.random.default_rng(1000 + ci)
    out = []
    for j in range(per_client):
        roll = rng.random()
        if roll < 0.45:
            q = KHop(int(rng.integers(0, n)), k=2)
        elif roll < 0.7:
            q = Reachability(int(rng.integers(0, n)),
                             int(rng.integers(0, n)), max_hops=6)
        elif roll < 0.85:
            q = DegreeTopK(5)
        else:
            q = PageRankQuery(top_k=4)
        droll = rng.random()
        if droll < 0.3:
            deadline = None
        elif droll < 0.9:
            deadline = 30.0
        else:
            deadline = float(rng.uniform(0.02, 0.1))
        pin = 0 if (j % 6 == 5 and j > 0) else None
        out.append((q, deadline, pin))
    return out


def _run_soak(*, n, epochs, adds, n_clients, per_client, stall_s,
              ingest_delay_s):
    tb, rb = both_streams("synthesize_churn_stream", n, epochs, adds,
                          seed=29, delete_frac=0.25, readd_frac=0.3)
    e_max = sum(len(b.add_src) for b in rb) + 16
    sg = TSharded(2, n, e_max, device="cpu")
    server = TServer(sg, auto_reshard=False, tol=1e-6, max_iter=100)
    server.step(tb[0])
    real_execute = server.engine.execute

    def stalling_execute(view, queries, **kw):
        if any(isinstance(q, tq.PageRankQuery) for q in queries):
            time.sleep(stall_s)
        return real_execute(view, queries, **kw)

    server.engine.execute = stalling_execute
    front = trpc.GraphRPCServer(server, port=0).start()
    host_, port = front.address
    results: dict[int, list] = {}
    errors: list[BaseException] = []

    def client(ci: int):
        mine = []
        try:
            with trpc.GraphRPCClient(host_, port) as c:
                pinned = None
                for j, (q, deadline, pin) in enumerate(
                        _client_queries(ci, per_client, n)):
                    r = c.query(port_query(q), deadline_s=deadline,
                                pin_version=(pinned if pin is not None
                                             else None))
                    assert r.request_id == j + 1, "response misrouted"
                    mine.append(r)
                    if r.ok and pinned is None:
                        pinned = r.version
        except BaseException as e:               # handed to the test
            errors.append(e)
        results[ci] = mine

    split = {}

    def pump():
        for e, b in enumerate(tb[1:], start=1):
            server.step(b)
            with server._ingest_lock:
                if e == max(2, epochs // 3):
                    split.update(sg.split_shard(0))
                elif e == max(3, (2 * epochs) // 3) and split:
                    sg.merge_shards(split["target"])
            time.sleep(ingest_delay_s)

    ingest = threading.Thread(target=pump, name="soak-ingest", daemon=True)
    ingest.start()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    ingest.join(120)
    assert not any(t.is_alive() for t in threads + [ingest]), "soak hung"
    stats = server.stats()
    front.stop()
    server.stop_prewarm()

    assert not errors, errors
    assert split and sg.retired, "split+merge must both have happened"
    for ci in range(n_clients):
        ids = [r.request_id for r in results[ci]]
        assert ids == list(range(1, per_client + 1)), f"client {ci}"
    flat = [r for rs in results.values() for r in rs]
    bad = [r for r in flat if not r.ok]
    assert all(r.error.code in TYPED_ERRORS for r in bad), \
        {r.error.code for r in bad}
    ok = [r for r in flat if r.ok]
    assert len(ok) >= len(flat) * 0.5

    # the reference's single-store replay is the oracle
    g = RGraph(n, e_max)
    for b in rb:
        g.apply(b)
    mismatches, audited = 0, 0
    for ci in range(n_clients):
        for (q, _dl, _pin), r in zip(_client_queries(ci, per_client, n),
                                     results[ci], strict=True):
            if not r.ok or isinstance(q, PageRankQuery):
                continue
            view = g.join_view(RV(r.version.epoch, r.version.number))
            if isinstance(q, KHop):
                want = np.asarray(rgc.k_hop(view, np.array([q.source]), q.k))
                same = host(r.value).tobytes() == want.tobytes()
            elif isinstance(q, Reachability):
                same = r.value == rgc.reachability(view, q.src, q.dst,
                                                   q.max_hops)
            else:
                ids, degs = r.value
                want_ids, want_degs = rgc.degree_topk(view, q.k)
                same = (host(ids).tobytes()
                        == np.asarray(want_ids).tobytes()
                        and host(degs).tobytes()
                        == np.asarray(want_degs).tobytes())
            audited += 1
            mismatches += 0 if same else 1
    assert audited > 0
    assert mismatches == 0, f"{mismatches}/{audited} audited answers wrong"
    return stats


def test_soak_quick_scale():
    """Four clients of twelve queries over a six-epoch churn stream with a
    split and a merge: the reference soak's quick scale."""
    stats = _run_soak(n=64, epochs=6, adds=80, n_clients=4, per_client=12,
                      stall_s=0.02, ingest_delay_s=0.01)
    assert stats.served > 0
    assert stats.split_events == 1 and stats.merge_events == 1


# ------------------------------------------------- chip_smoke.py phase 13
def test_chip_smoke_elastic_phase_rehearsal(tmp_path):
    """Phase 13 of chip_smoke.py on the CPU at a small size: 13a's
    planner splits, merge, seal fault and routed answers held against
    the two CPU oracles and a no-replica server, 13b's recovery onto the
    store's device and the CPU, 13c's kill -9 and ``--recover`` through
    the port's crash-recovery demo; and the three planted faults caught."""
    cs = load_chip_smoke()
    got = cs.elastic_plane(torch, "cpu", workdir=tmp_path, small=True)
    a, b, c = got["13a"], got["13b"], got["13c"]
    assert a["splits"] >= 1 and a["merges"] == 1 and a["epochs"] == 6
    assert a["degraded_epochs"] >= 1 and a["caught_up"]
    assert a["versions_checked"] == a["epochs"] and a["answers_checked"] > 0
    assert a["routed_windows"] > 0
    assert b["versions_checked"] == a["epochs"] + 2
    assert c["frontier"] >= 3 and c["audited"] == c["frontier"] + 1
    assert got["planted"] == {"split deletes left out of the stamp mirror":
                              "caught", "mirrors published one version "
                              "stale": "caught", "recovery without the "
                              "plan events": "caught"}
