"""The bytes one decode step of a DeepSeek-V2 model must move, averaged
over a call's ``gen`` steps after a ``prompt`` (the configuration's keys,
``deepseek_v2_weights``): every weight but the embedding table and the
routed experts' read once (matrices in the configuration's weight dtype,
norm scales and the router in float32, as the program reads them); of
each MoE layer's routed experts, the ``touched`` experts that a step's
tokens choose (a mean over steps and layers), each expert's three
matrices read once; and each layer's latent cache (the normed latent and
the rotated k_pe, in the weight dtype) at the positions the step attends
to, all up to it, read once. Over the card's HBM bandwidth, the step's
least time. The program reads every expert in a decode step; this is
what the step needs."""
from benchlib.deepseek_v2_weights import shape_of, specs
from benchlib.roofline import PEAKS

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _routed(name: str, shape: tuple) -> bool:
    return len(shape) == 3 and name.rsplit(".", 1)[-1] in ("w1", "w3", "w2")


def weight_bytes(config: dict, touched: float) -> float:
    """The weights a step reads: all but the embedding and the routed
    experts, then ``touched`` routed experts a MoE layer."""
    wsize = _SIZE[config["torch_dtype"]]
    s = shape_of(config)
    total = 0
    for name, shape, kind in specs(config):
        if name == "embed" or _routed(name, shape):
            continue
        n = 1
        for x in shape:
            n *= x
        total += n * (4 if kind in ("norm", "router") else wsize)
    expert = 3 * s["d"] * s["ffe"] * wsize
    return total + (s["layers"] - s["dense"]) * touched * expert


def cache_bytes(config: dict, batch: int, prompt: int, gen: int) -> float:
    """The latent cache one step reads, averaged over the ``gen`` steps
    (the step at position ``prompt + t`` attends to ``prompt + t + 1``)."""
    s = shape_of(config)
    per_position = batch * (s["r"] + s["rope"]) * _SIZE[config["torch_dtype"]]
    positions = sum(prompt + t + 1 for t in range(gen)) * s["layers"]
    return per_position * positions / gen


def bound_s(config: dict, batch: int, prompt: int, gen: int,
            touched: float) -> float:
    return (weight_bytes(config, touched)
            + cache_bytes(config, batch, prompt, gen)) \
        / PEAKS["hbm_bytes_per_s"]
