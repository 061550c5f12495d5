"""InternVL2-76B [arXiv:2404.16821]: InternLM2-76B language backbone
(80L, d_model=8192, 64 heads GQA kv=8, d_ff=28672, vocab 128256, SwiGLU,
RMSNorm, RoPE). InternViT frontend is a stub; input_specs() supplies
precomputed patch embeddings. Full attention => long_500k skip."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    pattern=("attn",),
    ffn="swiglu",
    norm="rms",
    rope=True,
    rope_theta=1_000_000.0,
    embed_mode="frames",
    subquadratic=False,
))
