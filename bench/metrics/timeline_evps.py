"""Graphalytics' EVPS: for every version whose PageRank and WCC both
finished inside the window, its vertex count plus live edge count,
summed, over the window's seconds."""


def read(run):
    done = [ev for t, ev in run.done_versions if run.in_window(t)]
    if not done:
        return None
    return sum(done) / run.seconds
