"""Milliseconds a WCC round: the program's ``Compute.wcc`` spans in the
traced sub-window, their durations summed over their rounds summed."""
from benchlib.program_spans import named


def read(run):
    calls = named(run, "Compute.wcc")
    rounds = sum(s.attrs["rounds"] for s in calls or ())
    if not rounds:
        return None
    return sum(s.end - s.start for s in calls) / rounds * 1e3
