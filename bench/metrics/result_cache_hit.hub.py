"""Share of the window's result-cache lookups that hit: the change in
``result_cache_hits`` over the change in hits plus misses."""
from benchlib.record import ratio_pct


def read(run):
    hits = run.delta("result_cache_hits")
    misses = run.delta("result_cache_misses")
    if hits is None or misses is None:
        return None
    return ratio_pct(hits, hits + misses)
