"""The prefill's share of the card's bfloat16 peak, in %: its model
operations (``bench/roofline/deepseek_v2_forward.py``) over the server's
``prefill_s`` times 989 TFLOP/s, the median over the window's calls."""
from benchlib.calls import median_of
from benchlib.roofline import PEAKS, load_count


def read(run):
    count = load_count("deepseek_v2_forward")
    peak = PEAKS["flops_per_s"][run.config["torch_dtype"]]
    return median_of(run, lambda s, e, a: 100.0 * count.prefill_flops(
        run.config, a["batch"], a["prompt"]) / (a["prefill_s"] * peak))
