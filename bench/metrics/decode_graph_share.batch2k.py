"""Share of the decode steps in the traced sub-window that replayed the
model's CUDA graph, in %: of the program's ``Model.decode`` spans (one a
decode step, ``launch/steps.py``), those whose ``route`` is "graph". None
where the program has no such span."""
from benchlib.program_spans import named


def read(run):
    steps = named(run, "Model.decode")
    if steps is None:
        return None
    return 100.0 * sum(s.attrs.get("route") == "graph"
                       for s in steps) / len(steps)
