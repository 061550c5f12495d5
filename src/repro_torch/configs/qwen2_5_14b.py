"""Qwen2.5-14B [hf:Qwen/Qwen2.5 family]: 48L, d_model=5120, 40 heads GQA kv=8,
d_ff=13824, vocab 152064, QKV bias, RoPE theta 1e6, SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    pattern=("attn",),
    ffn="swiglu",
    norm="rms",
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
))
