"""The dropless MoE's grouped expert products' share of their roofline
over the traced sub-window, in %: the bound of each grouped product the
profiler recorded (``bench/roofline/moe_experts.py``: the prefill's
groups of tokens, each reaching every expert; a decode step's batched
products are no grouped launch) over those launches' device time."""
from benchlib.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "moe_experts")
