"""A decode step's share of its byte bound, in %: the least time of a step
(``bench/roofline/mla_decode_step.py``: the weights but the embedding and
the routed experts, the routed experts a step's tokens touch, and the
latent cache up to the step, read once at 3.35 TB/s, averaged over the
call's steps) over the measured step (the server's ``decode_s`` over the
call's output tokens a sequence), the median over the window's calls. The
experts touched are the traced call's mean a step and MoE layer
(``run.counters["moe_decode_touched"]``); None without it."""
from benchlib.calls import median_of
from benchlib.roofline import load_count


def read(run):
    touched = run.counters.get("moe_decode_touched")
    if touched is None:
        return None
    count = load_count("mla_decode_step")
    return median_of(run, lambda s, e, a: 100.0 * count.bound_s(
        run.config, a["batch"], a["prompt"], a["gen"], touched)
        / (a["decode_s"] / a["gen"]))
