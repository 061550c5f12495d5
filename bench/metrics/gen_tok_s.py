"""Output tokens a second of the offline batches: the tokens of the calls
that finished inside the window, over the seconds from the window's open
to the last of those calls' end (a call still running at the close is not
counted, and the time after the last finish is not either)."""


def read(run):
    calls = run.window_spans("generate")
    if not calls:
        return None
    last = max(e for _, _, e, _ in calls)
    return sum(a["tokens"] for *_, a in calls) / (last - run.t_open)
