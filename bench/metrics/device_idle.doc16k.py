"""Share of the traced sub-window (a whole prefill and 32 decode steps)
in which nothing ran on the card: one less the union of the device's
kernels, copies and fills over the window's host time."""
from benchlib.record import device_idle_pct


def read(run):
    return device_idle_pct(run)
