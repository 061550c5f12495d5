"""Model operations of one ``Server.generate`` call of a dense decoder
(the configuration's keys, ``model_weights.shape_of``): 2 operations per
weight of each matrix product a token passes through, and the attention's
q k^T and P v, 2 x 2 x hd a head and visible (q, k) pair. The prefill
takes all layers over B x P tokens, causal, and the LM head over the last
position only (the program computes no other logits); each of the ``gen``
decode steps takes all layers and the LM head over B tokens, the token at
position P + t attending to P + t + 1 keys. Biases, norms, softmax and
the rotary embedding are left out (under 0.1 %)."""
from benchlib.model_weights import shape_of


def _per_token_layer(s: dict) -> int:
    """Weights of one layer's matrix products."""
    q, kv = s["hq"] * s["hd"], s["hkv"] * s["hd"]
    return s["d"] * (2 * q + 2 * kv) + 3 * s["d"] * s["ff"]


def prefill_flops(config: dict, batch: int, prompt: int) -> int:
    s = shape_of(config)
    mats = 2 * batch * prompt * s["layers"] * _per_token_layer(s)
    attn = 4 * batch * s["hq"] * s["hd"] * prompt * (prompt + 1) // 2 \
        * s["layers"]
    return mats + attn + 2 * batch * s["d"] * s["vocab"]


def decode_flops(config: dict, batch: int, prompt: int, gen: int) -> int:
    s = shape_of(config)
    per_step = 2 * batch * (s["layers"] * _per_token_layer(s)
                            + s["d"] * s["vocab"])
    keys = sum(prompt + t + 1 for t in range(gen))
    attn = 4 * batch * s["hq"] * s["hd"] * keys * s["layers"]
    return gen * per_step + attn


def generate_flops(config: dict, batch: int, prompt: int, gen: int) -> int:
    return prefill_flops(config, batch, prompt) \
        + decode_flops(config, batch, prompt, gen)
