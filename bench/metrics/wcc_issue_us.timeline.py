"""Host microseconds to issue one WCC round: the mean, over the
program's ``Compute.wcc.round`` spans in the traced sub-window, of the
span's duration less the time it waited on the ``changed`` read."""
from benchlib.program_spans import issue_us


def read(run):
    return issue_us(run, "Compute.wcc.round")
