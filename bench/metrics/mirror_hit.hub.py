"""Share of routed frontier vertices resolved from hub mirrors over the
window: the change in ``mirror_hits`` over the change in hits plus
misses."""
from benchlib.record import ratio_pct


def read(run):
    hits, misses = run.delta("mirror_hits"), run.delta("mirror_misses")
    if hits is None or misses is None:
        return None
    return ratio_pct(hits, hits + misses)
