"""StarCoder2-7B [arXiv:2402.19173]: 32L, d_model=4608, 36 heads GQA kv=4,
d_ff=18432 plain-GELU MLP with bias, vocab 49152, RoPE, LayerNorm."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    pattern=("attn",),
    ffn="gelu_mlp",
    norm="ln",
    qkv_bias=True,
    mlp_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
))
