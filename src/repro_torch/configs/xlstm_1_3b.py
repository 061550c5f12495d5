"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks, alternating mLSTM / sLSTM,
d_model=2048, 4 heads, no external FFN (d_ff=0; blocks carry their own
projections), vocab 50304. Sub-quadratic => runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    ffn="none",
    norm="ln",
    rope=False,
    pos_emb="none",
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    conv_width=4,
    subquadratic=True,
))
