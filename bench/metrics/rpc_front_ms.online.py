"""The RPC front's share of a query: the median, over answered window
queries, of the client's round trip (send to answer) less the server's
own ``latency_s`` (submission to answer), which the response carries."""
import numpy as np

from benchlib.record import answered


def read(run):
    ok = answered(run)
    if ok is None:
        return None
    q = run.queries
    front = (q["recv"][ok] - q["sent"][ok]) - q["lat"][ok]
    return float(np.median(front)) * 1e3
