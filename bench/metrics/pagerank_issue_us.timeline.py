"""Host microseconds to issue one PageRank iteration: the mean, over the
program's ``Compute.pagerank.iter`` spans in the traced sub-window, of
the span's duration less the time it waited on the residual's read."""
from benchlib.program_spans import issue_us


def read(run):
    return issue_us(run, "Compute.pagerank.iter")
