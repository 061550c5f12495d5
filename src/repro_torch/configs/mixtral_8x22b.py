"""Mixtral-8x22B [arXiv:2401.04088]: 56L, d_model=6144, 48 heads GQA kv=8,
8 experts top-2 with d_ff=16384 each, vocab 32768, SWA window 4096, SwiGLU
experts, RMSNorm, RoPE. SWA => sub-quadratic => runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=("swa",),
    ffn="moe",
    norm="rms",
    rope=True,
    rope_theta=1_000_000.0,
    swa_window=4096,
    n_experts=8,
    top_k=2,
    d_ff_expert=16384,
    expert_sharding="tensor",   # 8 experts % 16 != 0 -> TP inside experts
    subquadratic=True,
))
