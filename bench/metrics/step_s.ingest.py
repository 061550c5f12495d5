"""Mean wall time of the writer's ``GraphQueryServer.step`` calls (ingest,
seal, publish) that ended inside the window, by the harness's clock."""


def read(run):
    steps = run.window_spans("step")
    if not steps:
        return None
    return sum(e - s for _, s, e, _ in steps) / len(steps)
