"""``flash_attention``'s share of its roofline over the traced sub-window,
in %: the bound of each forward launch on the tensor cores the profiler
recorded (``bench/roofline/flash_attention.py``, at the shape of the
prefills the window ran) over those launches' device time."""
from benchlib.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "flash_attention")
