"""Programming models as protocol-dataflow *protocols* — paper §2.3.4.

"Protocol dataflow is general enough to be used to implement ... graph
parallel models (vertex-centric, edge-centric, graph-centric) and data
parallel models (MapReduce)". Each model here is a protocol (message format +
vertex semantics) over ``core.protocol_dataflow``; one dataflow vertex hosts
one *partition*.

The partitions compute on the host in NumPy float64, as the reference's do:
a model (or a Pregel partition) takes the view's edge and degree arrays
to the host once (:func:`_host_arrays`, through ``device.to_host``),
whatever device the view lives on, and then does the reference's
arithmetic in the reference's order, so its results equal the
reference's byte for byte. The results are checked against
``graph.compute``'s PageRank (``tests/test_torch_models.py``).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.protocol_dataflow import (CoalescingOutput, Dataflow,
                                                Egress, Ingress, Protocol,
                                                Vertex)
from repro_torch.device import to_host
from repro_torch.graph.dyngraph import JoinView


def _host_arrays(view: JoinView) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """The view's (src, dst, out_degree) as host arrays with the view's
    dtypes (int32, int32, float32): one copy from the device each."""
    return to_host(view.src), to_host(view.dst), to_host(view.out_degree)


# ----------------------------------------------------------------- vertex-centric
@dataclasses.dataclass
class PregelMsg:
    superstep: int
    # destination-partition payload: dict global dst id -> value
    values: dict


PREGEL = Protocol(
    name="pregel",
    validate=lambda m: isinstance(m, PregelMsg),
    happens_before=lambda e1, e2: (
        True if (e1.kind == "superstep" and e2.kind == "superstep"
                 and e1.payload is not None and e2.payload is not None
                 and e1.payload.get("part") == e2.payload.get("part")
                 and e1.payload["step"] < e2.payload["step"]) else None),
)


class PregelPartition(Vertex):
    """Hosts a contiguous vertex range; combiner=sum (coalescing output
    scheduler merges messages to the same destination partition).

    Execution is *asynchronous* (paper goal 3): a vertex re-emits only when
    its value moved by more than ``eps`` (change-driven halting); damping
    makes the chaotic relaxation converge to the synchronous fixed point.
    """

    def __init__(self, name, part_id, n_parts, view: JoinView,
                 vertex_program, init_value, n_local, eps=1e-12):
        super().__init__(
            name, PREGEL, fn=self._on_receive,
            output_scheduler=CoalescingOutput(
                key=lambda m: m.superstep,
                combine=_merge_pregel))
        self.part_id = part_id
        self.n_parts = n_parts
        self.n_local = n_local
        self.lo = part_id * n_local
        self.vertex_program = vertex_program
        self.eps = eps
        # local out-edges: src in range, any dst
        src, dst, _ = _host_arrays(view)
        sel = (src >= self.lo) & (src < self.lo + n_local)
        self.out_src = src[sel]
        self.out_dst = dst[sel]
        self.values = np.full(n_local, init_value, np.float64)
        self.out_degree = np.bincount(self.out_src - self.lo,
                                      minlength=n_local).astype(np.float64)
        self.first = True

    def _on_receive(self, _self, port, payloads):
        step = max(p.superstep for p in payloads)
        incoming = defaultdict(float)
        for p in payloads:
            for vid, val in p.values.items():
                incoming[vid] += val
        new_vals, out_value = self.vertex_program(self.values, incoming, self)
        changed = np.abs(new_vals - self.values) > self.eps
        if self.first:
            changedtous = np.ones_like(changed)
        else:
            changedtous = changed
        self.values = new_vals
        self.first = False
        self.emit_event("superstep", {"part": self.part_id, "step": step})
        if not changedtous.any():
            return ()
        # emit out-edge messages from changed vertices only
        buckets: dict[int, dict] = defaultdict(dict)
        for s, d in zip(self.out_src, self.out_dst, strict=True):
            li = s - self.lo
            if not changedtous[li]:
                continue
            p = min(int(d) // self.n_local, self.n_parts - 1)
            buckets[p][int(d)] = buckets[p].get(int(d), 0.0) + out_value[li]
        return [(f"to{p}", PregelMsg(step + 1, vals))
                for p, vals in buckets.items()]


def _merge_pregel(a: PregelMsg, b: PregelMsg) -> PregelMsg:
    vals = dict(a.values)
    for k, v in b.values.items():
        vals[k] = vals.get(k, 0.0) + v
    return PregelMsg(max(a.superstep, b.superstep), vals)


def run_pregel(view: JoinView, vertex_program, *, n_parts=4, init_value=0.0,
               supersteps=200, eps=1e-12) -> np.ndarray:
    """Run a vertex program until change-driven quiescence; returns the
    concatenated vertex values."""
    n_local = (view.n + n_parts - 1) // n_parts
    df = Dataflow("pregel")
    parts = [df.add(PregelPartition(f"part{p}", p, n_parts, view,
                                    vertex_program, init_value, n_local, eps))
             for p in range(n_parts)]
    ingress = df.add(Ingress("ingress", PREGEL))
    egress = df.add(Egress("egress", PREGEL, lambda m: None))
    for p, v in enumerate(parts):
        ingress.connect(f"to{p}", v, "in")
        for q, w in enumerate(parts):
            v.connect(f"to{q}", w, "in")
        v.connect("done", egress, "in")
    for p, v in enumerate(parts):
        ingress.push([PregelMsg(0, {})], out_port=f"to{p}")
    df.run_until_quiescent(max_rounds=supersteps * max(n_parts, 1) * 10)
    df.deliver_events()
    return np.concatenate([v.values for v in parts])[:view.n]


def pagerank_program(damping=0.85, n=None):
    """The classic Pregel PageRank vertex program.

    Because execution is message-driven, a vertex's rank is recomputed from
    the *accumulated* neighbor contributions; incoming carries deltas of
    src contributions, which the partition state tracks."""
    def program(values, incoming, part: PregelPartition):
        new = values.copy()
        if not hasattr(part, "acc"):
            part.acc = np.zeros(part.n_local, np.float64)
        for vid, val in incoming.items():
            li = vid - part.lo
            if 0 <= li < part.n_local:
                part.acc[li] += val
        new = (1 - damping) / n + damping * part.acc
        # out message value = DELTA of this vertex's contribution
        if not hasattr(part, "sent"):
            part.sent = np.zeros(part.n_local, np.float64)
        contrib = np.divide(new, np.maximum(part.out_degree, 1.0))
        delta = contrib - part.sent
        part.sent = contrib
        return new, delta
    return program


# ----------------------------------------------------------------- edge-centric
EDGE_CENTRIC = Protocol("xstream", validate=lambda m: isinstance(m, tuple))


def run_edge_centric(view: JoinView, *, n_parts=4, iters=10,
                     damping=0.85) -> np.ndarray:
    """X-Stream-style scatter/gather: stream edge partitions, scatter updates
    to a shuffler vertex, gather applies — PageRank as the example program."""
    n = view.n
    src, dst, out_degree = _host_arrays(view)
    bounds = np.linspace(0, len(src), n_parts + 1).astype(int)
    out_deg = np.maximum(out_degree, 1.0)
    state = {"pr": np.full(n, 1.0 / n)}

    df = Dataflow("xstream")
    def scatter_fn(vertex, port, payloads):
        outs = []
        for (lo, hi) in payloads:
            contrib = state["pr"][src[lo:hi]] / out_deg[src[lo:hi]]
            agg = np.bincount(dst[lo:hi], weights=contrib, minlength=n)
            outs.append(("out", ("partial", agg)))
        return outs

    def gather_fn(vertex, port, payloads):
        total = np.zeros(n)
        for (_, agg) in payloads:
            total += agg
        state["pr"] = (1 - damping) / n + damping * total
        return [("out", ("done", None))]

    ingress = df.add(Ingress("ingress", EDGE_CENTRIC))
    scatter = df.add(Vertex("scatter", EDGE_CENTRIC, scatter_fn,
                            budget=n_parts))
    gather = df.add(Vertex("gather", EDGE_CENTRIC, gather_fn,
                           budget=n_parts))
    egress = df.add(Egress("egress", EDGE_CENTRIC, lambda m: None))
    ingress.connect("out", scatter)
    scatter.connect("out", gather)
    gather.connect("out", egress)

    for _ in range(iters):
        ingress.push([(int(bounds[i]), int(bounds[i + 1]))
                      for i in range(n_parts)])
        df.run_until_quiescent()
    return state["pr"]


# -------------------------------------------------------------------- MapReduce
MAPREDUCE = Protocol("mapreduce", validate=lambda m: isinstance(m, tuple))


def run_mapreduce(records, map_fn, reduce_fn, *, n_reducers=4) -> dict:
    """MapReduce as a protocol: mapper vertex -> hash-shuffle -> reducers.
    Proves the data-parallel model runs on the same runtime (paper Fig 6)."""
    df = Dataflow("mapreduce")
    results: dict = {}

    def mapper(vertex, port, payloads):
        outs = []
        for tag, rec in payloads:
            for k, v in map_fn(rec):
                outs.append((f"r{hash(k) % n_reducers}", (k, v)))
        return outs

    def make_reducer(rid):
        def reducer(vertex, port, payloads):
            groups = defaultdict(list)
            for k, v in payloads:
                groups[k].append(v)
            for k, vs in groups.items():
                prev = results.get(k)
                vs = ([prev] if prev is not None else []) + vs
                results[k] = reduce_fn(k, vs)
            return [("out", ("ack", rid))]
        return reducer

    ingress = df.add(Ingress("ingress", MAPREDUCE,
                             encode=lambda rec: ("record", rec)))
    m = df.add(Vertex("map", MAPREDUCE, mapper, budget=1 << 20))
    egress = df.add(Egress("egress", MAPREDUCE, lambda x: None))
    ingress.connect("out", m)
    for r in range(n_reducers):
        red = df.add(Vertex(f"reduce{r}", MAPREDUCE, make_reducer(r)))
        m.connect(f"r{r}", red)
        red.connect("out", egress)
    ingress.push(records)
    df.run_until_quiescent()
    df.deliver_events()
    return results
