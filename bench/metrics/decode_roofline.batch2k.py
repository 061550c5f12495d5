"""A decode step's share of its byte bound, in %: the least time of a step
(``bench/roofline/decode_step.py``: the weights but the embedding and the
keys and values it attends to, read once at 3.35 TB/s, averaged over the
call's steps) over the measured step (the server's ``decode_s`` over the
call's output tokens a sequence), the median over the window's calls."""
from benchlib.calls import median_of
from benchlib.roofline import load_count


def read(run):
    count = load_count("decode_step")
    return median_of(run, lambda s, e, a: 100.0 * count.bound_s(
        run.config, a["batch"], a["prompt"], a["gen"])
        / (a["decode_s"] / a["gen"]))
