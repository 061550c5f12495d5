"""The comparison that decides ``correct``.

Every number compared is a count or a gap between what the timed path
produced and what :mod:`benchlib.reference` gives from the harness's own
stream, held against the limit that the configuration's ``limits`` names
for it (``bench/configs/<config>.json``; how each limit was set is in
PERF.md). ``correct`` is true when every number is at or under its limit.

With ``control`` set, the reference itself computed one precision below
the configuration's (bfloat16 for float32) takes the program's place for
the answers that carry floating-point values (served degrees and ranks,
the timeline's ranks): the control has to come out not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from benchlib import loadgen
from benchlib.reference import RefGraph, live_graph

CONTROL_DTYPE = torch.bfloat16


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {}
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def _control_topk(g: RefGraph, k: int):
    deg = g.in_deg.to(CONTROL_DTYPE)
    vals, ids = torch.sort(deg, descending=True, stable=True)
    return ids[:k], vals[:k].float()


def _topk_ranks(ranks: torch.Tensor, k: int):
    full = ranks.float().cpu().numpy()
    ids = np.argsort(-full, kind="stable")[:k]
    return ids, full[ids]


def serve_numbers(run, stream, layout, pagerank_kw: dict, *,
                  control: bool = False) -> dict:
    """Numbers of a serving cell: every published snapshot's digest, and
    the sampled answers, each at the version it was answered at."""
    p = run.traffic["queries"]
    q = run.queries
    keys = loadgen.Keys(p["keys"], stream.n, run.seed,
                        stream.perm.cpu().numpy())
    _, frames = loadgen.schedule(run.seed, 1, p["rate_per_s"], run.seconds,
                                 p["mix"], keys)
    sampled = loadgen.sample_ids(run.seed, len(frames), p["sample"])
    answers = q["answers"]
    published = {v: d for _, v, d in run.publishes}
    ok = q["state"] == 1
    out = {"snapshot_mismatch": 0,
           "unanswered": int((q["state"] == 0).sum()),
           "unpublished_version": int(sum(int(v) not in published
                                          for v in q["version"][ok])),
           "khop_mismatch": 0, "reach_mismatch": 0, "topk_mismatch": 0,
           "pagerank_topk_rel": 0.0}
    # every epoch the writer handed to step and saw return is published
    out["lost_epochs"] = sum(1 for name, *_, a in run.spans
                             if name == "step" and a["epoch"] not in
                             {v >> 32 for v in published})
    by_version: dict[int, list[int]] = {}
    for i in sampled:
        if q["state"][i] == 1 and int(i) in answers:
            by_version.setdefault(int(q["version"][i]), []).append(int(i))
    for v in sorted(set(published) | set(by_version)):
        g = live_graph(stream, layout, v >> 32)
        if v in published and published[v] != g.digest():
            out["snapshot_mismatch"] += 1
        ranks = None
        for i in by_version.get(v, []):
            f, val = frames[i], answers[i]
            args = f["query"]
            if f["kind"] == "k_hop":
                want = g.k_hop(args["source"], args["k"]).cpu().numpy()
                out["khop_mismatch"] += int((np.asarray(val[0]) != want)
                                            .sum())
            elif f["kind"] == "reachability":
                want = g.reachable(args["src"], args["dst"],
                                   args["max_hops"])
                out["reach_mismatch"] += int(bool(val[0]) != want)
            elif f["kind"] == "degree_topk":
                ids, degs = g.degree_topk(args["k"])
                got_ids, got_degs = val
                if control:
                    got_ids, got_degs = (t.cpu().numpy() for t in
                                         _control_topk(g, args["k"]))
                out["topk_mismatch"] += int(
                    (np.asarray(got_ids) != ids.cpu().numpy()).sum()
                    + (np.asarray(got_degs, np.float64)
                       != degs.cpu().numpy()).sum())
            elif f["kind"] == "pagerank":
                if ranks is None:
                    ranks = g.pagerank(**pagerank_kw)[0].cpu().numpy()
                got_ids, got_ranks = val
                if control:
                    low = g.pagerank(dtype=CONTROL_DTYPE, tol=1e-6,
                                     max_iter=200)[0]
                    got_ids, got_ranks = _topk_ranks(low, args["top_k"])
                ref = ranks[np.asarray(got_ids, np.int64)]
                rel = np.abs(np.asarray(got_ranks, np.float64) - ref) / ref
                out["pagerank_topk_rel"] = max(out["pagerank_topk_rel"],
                                               float(rel.max()))
        del g
    return out


def timeline_numbers(results: dict, stream, layout, pagerank_kw: dict, *,
                     control: bool = False) -> dict:
    """Numbers of a timeline cell: per version, the snapshot's digest, the
    ranks' L1 distance from float64 ranks, and the WCC labels."""
    out = {"snapshot_mismatch": 0, "pagerank_l1": 0.0, "wcc_mismatch": 0}
    for epoch in sorted(results):
        res = results[epoch]
        g = live_graph(stream, layout, epoch)
        if res["digest"] != g.digest():
            out["snapshot_mismatch"] += 1
        ref = g.pagerank(**pagerank_kw)[0]
        ranks = res["ranks"]
        if control:
            ranks = g.pagerank(dtype=CONTROL_DTYPE, tol=1e-6,
                               max_iter=200)[0]
        l1 = float((ranks.to(ref.device).double() - ref).abs().sum())
        out["pagerank_l1"] = max(out["pagerank_l1"], l1)
        out["wcc_mismatch"] += int(
            (res["labels"].to(ref.device).long() != g.wcc()).sum())
        del g
    return out
