"""Set-up seconds: process start to the window's open (loading, the base
ingest, the warm-up phase and, on a first run, the kernel build)."""


def read(run):
    return run.setup_s
