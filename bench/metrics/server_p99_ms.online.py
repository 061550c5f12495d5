"""99th percentile of the responses' server-side ``latency_s`` over the
window's answered queries (not ``ServerStats.query_p99_s``, which covers
only the server's last 8,192 queries, warm-up included)."""
from benchlib.record import answered, nearest_rank


def read(run):
    ok = answered(run)
    if ok is None:
        return None
    return nearest_rank(run.queries["lat"][ok] * 1e3, 99)
