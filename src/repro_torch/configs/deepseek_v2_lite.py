"""DeepSeek-V2-Lite (15.7B total, 2.4B active) [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2-Lite config.json]: 27L, d_model=2048, 16
heads of multi-head latent attention (kv_lora_rank 512, no q LoRA, qk
nope/rope 128/64, v 128), YaRN rotary (theta 1e4, factor 40 over 4096
positions, beta 32/1, mscale 0.707 both), vocab 102400 untied, RMSNorm
1e-6. Layer 0 a SwiGLU of 10944; layers 1-26 DeepSeekMoE: 64 routed
experts of 1408, top-6 of a float32 softmax, not renormalised, and 2
shared experts (one SwiGLU of 2816). The port's own architecture: the
reference has no latent attention."""
from repro_torch.configs.base import ModelConfig, YaRN, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,               # v_head_dim: the output projection's heads
    d_ff=10944,
    vocab_size=102400,
    pattern=("mla",),
    ffn="moe",
    norm="rms",
    rope=True,
    rope_theta=10_000.0,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    moe_impl="dropless",
    expert_sharding="expert",
    subquadratic=False,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling=YaRN(factor=40.0, original_max_position=4096,
                      beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                      mscale_all_dim=0.707),
    n_shared_experts=2,
    first_k_dense=1,
    norm_topk_prob=False,
))
