"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: 26L, d_model=2560,
10 heads MQA kv=1 head_dim=256, d_ff=7680 (geglu), vocab 256000,
pattern (RG-LRU, RG-LRU, local-attn window 2048). Hybrid => runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    ffn="geglu",
    norm="rms",
    rope=True,
    rope_theta=10_000.0,
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    scale_embeddings=True,
    subquadratic=True,
))
