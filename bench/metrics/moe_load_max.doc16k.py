"""The routing's worst imbalance in the traced call's prefill: over the
MoE layers, the most-loaded expert's routed slots over the mean slots an
expert, from the program's per-layer expert-load counters
(``MoE.load``), as the run read them after the call. None where the
program keeps no such counter."""


def read(run):
    loads = run.counters.get("moe_prefill_load")
    if not loads:
        return None
    return max(max(layer) * len(layer) / sum(layer) for layer in loads
               if sum(layer))
