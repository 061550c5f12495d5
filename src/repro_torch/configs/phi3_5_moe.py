"""Phi-3.5-MoE (42B total, 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
32L, d_model=4096, 32 heads GQA kv=8, 16 experts top-2 with d_ff=6400 each,
vocab 32064, SwiGLU experts, RMSNorm, RoPE. Full attention => long_500k skip."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    pattern=("attn",),
    ffn="moe",
    norm="rms",
    rope=True,
    rope_theta=10_000.0,
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
    expert_sharding="expert",   # 16 experts % 16 == 0 -> expert parallel on model axis
    subquadratic=False,
))
