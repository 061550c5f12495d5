"""``decode_attention``'s share of its byte bound over the traced
sub-window, in %: the bound of the traced call's first
``trace_decode_steps`` decode steps (step t attends to prompt + t + 1
positions in each of the configuration's layers;
``bench/roofline/decode_attention.py``, shapes from the configuration,
batch and prompt from the traced ``generate`` span) over the device time
the profiler recorded for the kernels whose names hold ``KERNEL_NAMES``
(the attention kernel and, where the range is split, the combine). A
launch the profiler dropped comes out of both sides: the bound is scaled
by the launches recorded over one a layer and step, when fewer. None
without such launches (a program whose decode attention is not that
kernel) or without the traced call."""
from benchlib.model_weights import shape_of
from benchlib.roofline import bound_s, load_count


def read(run):
    tr = run.trace
    traced = [a for name, _, _, a in run.spans
              if name == "generate" and a.get("traced")]
    if not tr or not traced:
        return None
    mod = load_count("decode_attention")
    seen = [v for name, v in tr["kernels"].items()
            if any(k in name for k in mod.KERNEL_NAMES)]
    launches = sum(c for c, _ in seen)
    seconds = sum(s for _, s in seen)
    if not launches or seconds <= 0:
        return None
    call, s = traced[0], shape_of(run.config)
    steps = min(run.traffic["trace_decode_steps"], call["gen"])
    bound = s["layers"] * sum(bound_s(mod, {
        "b": call["batch"], "hq": s["hq"], "hkv": s["hkv"],
        "s": call["prompt"] + t + 1, "hd": s["hd"],
        "dtype": run.config["torch_dtype"]}) for t in range(steps))
    recorded = min(1.0, launches / (s["layers"] * steps))
    return 100.0 * bound * recorded / seconds
