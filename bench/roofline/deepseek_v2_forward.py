"""Model operations of one ``Server.generate`` call of DeepSeek-V2 (the
configuration's keys, ``deepseek_v2_weights.shape_of``): 2 operations per
weight of each matrix product a token passes through, and the latent
attention's 2 x (qk_nope + qk_rope + v) a head and visible (q, k) pair
(the decompressed form's q k^T and P v, whichever form runs). A token
takes, in every layer, the attention's projections (W_q, W_kva, W_kvb,
W_o); in the first ``first_k_dense_replace`` layers the dense SwiGLU, in
the rest the router, its ``num_experts_per_tok`` routed experts and the
shared experts. The prefill takes all layers over B x P tokens, causal,
and the LM head over the last position only (the program computes no
other logits); each of the ``gen`` decode steps takes all layers and the
LM head over B tokens, the token at position P + t attending to P + t +
1 keys. Norms, softmax, rotary embeddings and the combine are left out
(under 0.1 %)."""
from benchlib.deepseek_v2_weights import shape_of


def per_token(s: dict) -> int:
    """Operations of one token through every layer but the attention's
    pairs."""
    d, h = s["d"], s["h"]
    attn = d * h * (s["nope"] + s["rope"]) + d * (s["r"] + s["rope"]) \
        + s["r"] * h * (s["nope"] + s["v"]) + h * s["v"] * d
    dense = 3 * d * s["ff"]
    moe = d * s["e"] + (s["k"] + s["shared"]) * 3 * d * s["ffe"]
    moe_layers = s["layers"] - s["dense"]
    return 2 * (s["layers"] * attn + s["dense"] * dense + moe_layers * moe)


def pair_flops(s: dict) -> int:
    """Operations of one visible (q, k) pair over all heads and layers."""
    return 2 * (s["nope"] + s["rope"] + s["v"]) * s["h"] * s["layers"]


def prefill_flops(config: dict, batch: int, prompt: int) -> int:
    s = shape_of(config)
    return batch * prompt * per_token(s) \
        + batch * prompt * (prompt + 1) // 2 * pair_flops(s) \
        + 2 * batch * s["d"] * s["vocab"]


def decode_flops(config: dict, batch: int, prompt: int, gen: int) -> int:
    s = shape_of(config)
    keys = sum(prompt + t + 1 for t in range(gen))
    return gen * batch * (per_token(s) + 2 * s["d"] * s["vocab"]) \
        + batch * keys * pair_flops(s)


def generate_flops(config: dict, batch: int, prompt: int, gen: int) -> int:
    return prefill_flops(config, batch, prompt) \
        + decode_flops(config, batch, prompt, gen)
