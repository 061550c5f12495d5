"""Mean label-propagation rounds per WCC call: the ``rounds`` of the
program's ``Compute.wcc`` spans that ended in the traced sub-window."""
from benchlib.program_spans import named


def read(run):
    calls = named(run, "Compute.wcc")
    if calls is None:
        return None
    return sum(s.attrs["rounds"] for s in calls) / len(calls)
