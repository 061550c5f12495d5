"""``wcc_round``'s share of its byte bound over the traced sub-window: the
mean bound of a round (``bench/roofline/wcc_round.py``, from the ``m`` and
``n`` of the program's ``Compute.wcc`` spans, each weighted by its
``rounds``) times the launches of ``wcc_round_kernel`` the profiler
recorded, over their recorded device time. None without such launches
(a program whose WCC rounds are not that kernel) or without the spans."""
from benchlib.program_spans import named
from benchlib.roofline import bound_s, load_count


def read(run):
    calls = named(run, "Compute.wcc")
    rounds = sum(s.attrs["rounds"] for s in calls or ())
    if not rounds:
        return None
    mod = load_count("wcc_round")
    mean_bound = sum(s.attrs["rounds"] * bound_s(
        mod, {"m": s.attrs["m"], "n": s.attrs["n"]}) for s in calls) / rounds
    seen = [v for name, v in run.trace["kernels"].items()
            if any(k in name for k in mod.KERNEL_NAMES)]
    count = sum(c for c, _ in seen)
    seconds = sum(s for _, s in seen)
    if not count or seconds <= 0:
        return None
    return 100.0 * count * mean_bound / seconds
