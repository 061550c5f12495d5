"""99th percentile of the same client latencies as ``query_p50_ms``."""
from benchlib.record import client_latencies_ms, nearest_rank


def read(run):
    lat = client_latencies_ms(run)
    return None if lat is None else nearest_rank(lat, 99)
