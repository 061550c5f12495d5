"""The parallel shard apply's critical path: the mean, over the
program's ``Write.seal`` spans in the traced sub-window, of the longest
``Write.shard_apply`` span each seal caused, in ms."""
from benchlib.program_spans import named


def read(run):
    seals = named(run, "Write.seal")
    applies = named(run, "Write.shard_apply")
    if seals is None or applies is None:
        return None
    longest: dict = {}
    for s in applies:
        longest[s.parent] = max(longest.get(s.parent, 0.0), s.end - s.start)
    found = [longest[s.id] for s in seals if s.id in longest]
    if not found:
        return None
    return sum(found) / len(found) * 1e3
