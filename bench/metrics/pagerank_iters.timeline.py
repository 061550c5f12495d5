"""Mean PageRank iterations per version over the window's calls."""


def read(run):
    calls = run.window_spans("pagerank")
    if not calls:
        return None
    return sum(a["iterations"] for *_, a in calls) / len(calls)
