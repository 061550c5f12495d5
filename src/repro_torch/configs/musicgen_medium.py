"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.
48L, d_model=1536, 24 heads MHA (kv=24), d_ff=6144 plain GELU, vocab 2048.
Backbone only: the EnCodec frontend is a stub; input_specs() supplies
precomputed frame embeddings (B, S, d_model). Full attention => long_500k skip."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    ffn="gelu_mlp",
    norm="ln",
    rope=False,
    pos_emb="sinusoidal",
    embed_mode="frames",
    subquadratic=False,
))
