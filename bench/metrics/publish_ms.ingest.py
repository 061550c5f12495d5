"""Mean milliseconds of the program's ``Write.publish`` spans in the
traced sub-window: the stitch of the sealed epoch's view and its swap
into the read plane."""
from benchlib.program_spans import named


def read(run):
    found = named(run, "Write.publish")
    if found is None:
        return None
    return sum(s.end - s.start for s in found) / len(found) * 1e3
