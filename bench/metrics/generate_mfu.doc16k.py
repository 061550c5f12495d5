"""The whole call's share of the card's bfloat16 peak, in %: the model
operations of a ``Server.generate`` call (``bench/roofline/
deepseek_v2_forward.py``: prefill and every decode step) over the call's
wall time by the harness's clock times 989 TFLOP/s, the median over the
window's calls."""
from benchlib.calls import median_of
from benchlib.roofline import PEAKS, load_count


def read(run):
    count = load_count("deepseek_v2_forward")
    peak = PEAKS["flops_per_s"][run.config["torch_dtype"]]
    return median_of(run, lambda s, e, a: 100.0 * count.generate_flops(
        run.config, a["batch"], a["prompt"], a["gen"]) / ((e - s) * peak))
