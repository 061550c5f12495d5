"""Milliseconds a decode step: the median over the window's calls of the
server's ``decode_s`` (the decode loop, ending in the tokens' copy to the
host) over the call's output tokens a sequence."""
from benchlib.calls import median_of


def read(run):
    return median_of(run, lambda s, e, a: a["decode_s"] / a["gen"] * 1e3)
