"""The bytes one decode step of a dense decoder must move, averaged over a
call's ``gen`` steps after a ``prompt`` (``chip_smoke.decode_bound``'s
count): every weight but the embedding table read once (matrices in the
configuration's weight dtype, norm scales and biases in float32, as the
program reads them), and each layer's keys and values at the positions
the step attends to (all up to it) read once, in the weight dtype; over
the card's HBM bandwidth, the step's least time."""
from benchlib.model_weights import shape_of, specs
from benchlib.roofline import PEAKS

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def weight_bytes(config: dict) -> int:
    wsize = _SIZE[config["torch_dtype"]]
    total = 0
    for name, shape, kind in specs(config):
        if name == "embed":
            continue
        n = 1
        for x in shape:
            n *= x
        total += n * (wsize if kind == "matrix" else 4)
    return total


def cache_bytes(config: dict, batch: int, prompt: int, gen: int) -> float:
    """The keys and values one step reads, averaged over the ``gen``
    steps."""
    s = shape_of(config)
    per_position = 2 * batch * s["hkv"] * s["hd"] * _SIZE[config["torch_dtype"]]
    positions = sum(prompt + t + 1 for t in range(gen)) * s["layers"]
    return per_position * positions / gen


def bound_s(config: dict, batch: int, prompt: int, gen: int) -> float:
    return (weight_bytes(config) + cache_bytes(config, batch, prompt, gen)) \
        / PEAKS["hbm_bytes_per_s"]
