"""Mutations a second that the write plane sealed and published: the adds
plus deletes of every epoch published after the window's first publish
and up to its last, over the time between those two publishes."""


def read(run):
    pubs = [(t, v) for t, v, _ in run.publishes if run.in_window(t)]
    if len(pubs) < 2:
        return None
    muts = sum(run.epoch_mutations.get(v >> 32, 0) for _, v in pubs[1:])
    return muts / (pubs[-1][0] - pubs[0][0])
