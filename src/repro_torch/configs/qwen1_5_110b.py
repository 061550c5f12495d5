"""Qwen1.5-110B [hf:Qwen/Qwen1.5 family]: 80L, d_model=8192, 64 heads GQA kv=8,
d_ff=49152, vocab 152064, QKV bias, RoPE theta 1e6, SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    pattern=("attn",),
    ffn="swiglu",
    norm="rms",
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
))
