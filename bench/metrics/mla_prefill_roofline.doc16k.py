"""The latent attention's prefill kernel's share of its roofline over the
traced sub-window, in %: the bound of each flash-attention launch the
profiler recorded, on the attention's unpadded dims
(``bench/roofline/mla_prefill.py``), over those launches' device time."""
from benchlib.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "mla_prefill")
