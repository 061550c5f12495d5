"""Architecture config system (the port's copy of ``repro/configs/base.py``).

Every architecture is described by one :class:`ModelConfig`. A config is
*declarative*: it fixes the block pattern (the repeating unit of mixer
kinds), the FFN kind and the attention details; ``models/transformer.py``
instantiates it. The dataclass, ``reduced`` and the registry functions are
the reference's, field for field, so a config means the same model in both
packages, and the registry holds the reference's ten architectures. The
port adds the fields of DeepSeek-V2's latent attention and DeepSeekMoE
(``kv_lora_rank`` onwards), each defaulting to "absent", and one
architecture of its own, ``deepseek-v2-lite``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence

MixerKind = Literal["attn", "swa", "local", "global", "rglru", "mlstm",
                    "slstm", "mla"]
FFNKind = Literal["swiglu", "geglu", "gelu_mlp", "moe", "none"]
NormKind = Literal["rms", "ln"]
EmbedMode = Literal["tokens", "frames"]

ATTN_KINDS = ("attn", "swa", "local", "global")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")
# the mixers followed by a feed-forward
FFN_MIXERS = ATTN_KINDS + ("rglru", "mla")


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's rotary scaling (DeepSeek-V2's ``rope_scaling`` with
    ``type`` "yarn"): the frequencies of the slow dimensions divided by
    ``factor``, blended into the fast ones over the correction range that
    ``beta_fast`` and ``beta_slow`` rotations at
    ``original_max_position`` give; attention scores scaled by
    ``mscale(factor, mscale_all_dim)^2`` and the rotary table by
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # Block pattern: repeating unit of mixer kinds; num_layers = k*len(pattern)+r.
    pattern: Sequence[MixerKind] = ("attn",)
    ffn: FFNKind = "swiglu"
    norm: NormKind = "rms"
    # attention details
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    local_window: int = 1024          # for "local" mixers
    swa_window: int = 4096            # for "swa" mixers
    qk_norm: bool = False
    sandwich_norm: bool = False       # post-block norms (gemma3)
    logit_softcap: float = 0.0        # final-logit softcapping (gemma family)
    attn_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    moe_impl: Literal["dense", "dropping", "dropless"] = "dense"
    capacity_factor: float = 1.25
    expert_sharding: Literal["tensor", "expert"] = "tensor"
    # recurrent blocks
    lru_width: int = 0                # rglru inner width (0 -> d_model)
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    # embeddings
    embed_mode: EmbedMode = "tokens"
    pos_emb: Literal["rope", "sinusoidal", "none"] = "rope"
    tie_embeddings: bool = False
    scale_embeddings: bool = False    # multiply embeddings by sqrt(d_model)
    # numerics
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    # §Perf knobs (beyond-paper optimizations; defaults = paper-faithful
    # baseline)
    reduce_dtype: str = "float32"     # dtype of TP partial-sum all-reduces
    bwd_dtype: str = "float32"        # cotangent dtype through dense layers
    mlstm_chunk: int = 0              # 0 = plain scan; >0 = chunk size
    mlstm_impl: str = "scan"          # scan | chunkwise (parallel intra-chunk)
    moe_groups: int = 0               # >1: shard-local MoE dispatch groups
    microbatches: int = 1             # gradient-accumulation splits per step
    # long-context capability: does the arch admit a 500k decode cell?
    subquadratic: bool = False
    # attention kv-chunk size for the jnp flash path
    kv_chunk: int = 1024
    # remat policy for the scanned block: none | dots | full
    remat: str = "full"
    # loss vocab chunking (tokens per chunk in the chunked CE)
    loss_chunk: int = 2048
    # multi-head latent attention (mixer kind "mla", DeepSeek-V2): keys and
    # values from a normed latent of kv_lora_rank, queries and keys of
    # qk_nope_head_dim + qk_rope_head_dim (the rotated part one key head
    # shared by all), values of v_head_dim; 0 where absent
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_scaling: Optional[YaRN] = None
    # DeepSeekMoE: n_shared_experts experts of d_ff_expert as one SwiGLU
    # that every token takes; the first first_k_dense layers a SwiGLU of
    # d_ff; routing weights renormalised over the top-k (norm_topk_prob)
    n_shared_experts: int = 0
    first_k_dense: int = 0
    norm_topk_prob: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def num_units(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Sequence[MixerKind]:
        r = self.num_layers % len(self.pattern)
        return tuple(self.pattern[:r])

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab_size
        total = 0
        if self.embed_mode == "tokens":
            total += v * d
        total += d * v  # lm head
        for layer, kind in enumerate(self.layer_kinds()):
            total += self._block_params(kind, layer)
        total += d  # final norm
        return total

    def layer_kinds(self) -> list:
        """The mixer kind of each layer, in order."""
        return list(self.pattern) * self.num_units + list(self.tail_pattern)

    def ffn_kind(self, layer: int) -> str:
        """The feed-forward of ``layer``: ``cfg.ffn``, or "swiglu" for the
        first ``first_k_dense`` layers of an MoE model."""
        if self.ffn == "moe" and layer < self.first_k_dense:
            return "swiglu"
        return self.ffn

    def _block_params(self, kind: str, layer: Optional[int] = None) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        n = 0
        if kind == "mla":
            h, r = self.n_heads, self.kv_lora_rank
            n += d * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            n += d * (r + self.qk_rope_head_dim) + r
            n += r * h * (self.qk_nope_head_dim + self.v_head_dim)
            n += h * self.v_head_dim * d + d
        elif kind in ATTN_KINDS:
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                n += self.q_dim + 2 * self.kv_dim
            n += d  # pre-norm
            if self.sandwich_norm:
                n += d
            if self.qk_norm:
                n += 2 * hd
        elif kind == "rglru":
            w = self.lru_width or d
            n += 2 * d * w + w * d + self.conv_width * w + 4 * w + d
        elif kind == "mlstm":
            dp = int(self.mlstm_proj_factor * d)
            h = self.n_heads
            # up proj (x + ogate branches), down proj, conv, per-head block-diag
            # qkv, i/f gate projections (dp -> h scalars each), pre-norm.
            n += d * 2 * dp + dp * d + self.conv_width * dp
            n += 3 * h * (dp // h) ** 2 + 2 * dp * h + d
        elif kind == "slstm":
            h = self.n_heads
            hd_s = d // h
            # input projections for 4 gates, per-head recurrent matrices for
            # 4 gates, biases, pre-norm, gated ffn (proj_factor).
            n += 4 * d * d + 4 * h * hd_s * hd_s + 8 * d + d
            dff_s = int(self.slstm_proj_factor * d)
            n += 2 * d * dff_s + dff_s * d
        # FFN
        ffn = self.ffn if layer is None else self.ffn_kind(layer)
        if kind in FFN_MIXERS:
            if ffn in ("swiglu", "geglu"):
                n += 3 * d * self.d_ff + d
            elif ffn == "gelu_mlp":
                n += 2 * d * self.d_ff + d
                if self.mlp_bias:
                    n += self.d_ff + d
            elif ffn == "moe":
                ffe = self.d_ff_expert or self.d_ff
                n += d * self.n_experts + self.n_experts * 3 * d * ffe + d
                n += self.n_shared_experts * 3 * d * ffe
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k experts only; shared
        experts and dense layers count whole)."""
        if self.ffn != "moe":
            return self.param_count()
        ffe = self.d_ff_expert or self.d_ff
        per_layer_moe = self.n_experts * 3 * self.d_model * ffe
        active_moe = self.top_k * 3 * self.d_model * ffe
        n_moe_layers = sum(
            1 for layer, k in enumerate(self.layer_kinds())
            if k in FFN_MIXERS and self.ffn_kind(layer) == "moe")
        return self.param_count() - n_moe_layers * (per_layer_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # import for registration side effects
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite, gemma3_27b, internvl2_76b, mixtral_8x22b,
        musicgen_medium, phi3_5_moe, qwen1_5_110b, qwen2_5_14b,
        recurrentgemma_2b, starcoder2_7b, xlstm_1_3b,
    )


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.pattern
    base = {
        "num_layers": max(2, len(pat)),
        "d_model": 64,
        "n_heads": max(2, min(4, cfg.n_heads)),
        "n_kv_heads": max(1, min(2, cfg.n_kv_heads)),
        "head_dim": 16,
        "d_ff": 128 if cfg.d_ff else 0,
        "vocab_size": 256,
        "n_experts": min(4, cfg.n_experts) if cfg.n_experts else 0,
        "d_ff_expert": 64 if cfg.d_ff_expert else 0,
        "lru_width": 64 if cfg.lru_width else 0,
        "local_window": 8,
        "swa_window": 8,
        "kv_chunk": 16,
        "loss_chunk": 64,
        "name": cfg.name + "-smoke",
    }
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
