"""Median client latency of every query due in the window, from its due
time to its answer (failed, shed or missing queries as the slowest)."""
from benchlib.record import client_latencies_ms, nearest_rank


def read(run):
    lat = client_latencies_ms(run)
    return None if lat is None else nearest_rank(lat, 50)
