"""Milliseconds a PageRank iteration: the harness's span around each
PageRank call, summed over the window's calls, over their iterations."""


def read(run):
    calls = run.window_spans("pagerank")
    iters = sum(a["iterations"] for *_, a in calls)
    if not iters:
        return None
    return sum(e - s for _, s, e, _ in calls) / iters * 1e3
