"""95th percentile of the same client latencies as ``query_p50_ms``: the
tail of a cell whose knee leaves a few hundred queries in its window, at
least ten of them beyond the 95th percentile."""
from benchlib.record import client_latencies_ms, nearest_rank


def read(run):
    lat = client_latencies_ms(run)
    return None if lat is None else nearest_rank(lat, 95)
