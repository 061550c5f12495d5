"""Gemma3-27B [hf:google/gemma-3 family]: 62L, d_model=5376, 32 heads GQA
kv=16, head_dim=128, d_ff=21504 (geglu), vocab 262144, 5:1 local:global
(window 1024), qk-norm, sandwich norms, 128k context. Mostly-local attention
=> runs long_500k (global layers linear-cost at decode)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    ffn="geglu",
    norm="rms",
    rope=True,
    rope_theta=1_000_000.0,
    local_window=1024,
    qk_norm=True,
    sandwich_norm=True,
    scale_embeddings=True,
    subquadratic=True,   # 5:1 local:global; global layers linear at decode
))
