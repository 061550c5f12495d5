"""``segment_sum``'s share of its byte bound over the traced sub-window:
the bound of each launch the profiler recorded (``bench/roofline/
segment_sum.py``, from the (m, n, F) of the calls the window made) over
the device time of those launches."""
from benchlib.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "segment_sum")
