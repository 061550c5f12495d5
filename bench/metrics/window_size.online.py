"""Queries one vectorized window answers: the change in the server's
``served`` over the change in its ``windows`` across the window."""


def read(run):
    served, windows = run.delta("served"), run.delta("windows")
    if not served or not windows:
        return None
    return served / windows
