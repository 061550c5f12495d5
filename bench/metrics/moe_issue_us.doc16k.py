"""Host microseconds of a decode step's MoE layer: the mean length of the
program's ``Model.moe`` spans over a decode step's batch of tokens in the
traced sub-window (the host's issue of the routing, the dispatch's
grouped products and the combine; nothing in the span waits on the
card). None where the program has no such span."""
from benchlib.program_spans import named


def read(run):
    spans = named(run, "Model.moe")
    if spans is None:
        return None
    steps = [s for s in spans if s.attrs.get("tokens") == run.traffic["batch"]]
    if not steps:
        return None
    return sum(s.end - s.start for s in steps) / len(steps) * 1e6
