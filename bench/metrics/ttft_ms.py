"""Time to the first token of a batch, in ms: the median over the window's
calls of the server's ``prefill_s`` (the prompts' copy to the card and the
prefill, ending in a device synchronise; the first token is the argmax of
its logits)."""
from benchlib.calls import median_of


def read(run):
    return median_of(run, lambda s, e, a: a["prefill_s"] * 1e3)
