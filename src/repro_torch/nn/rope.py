"""Rotary position embeddings (half-rotation layout, LLaMA-style); the port
of ``repro/nn/rope.py``. Below it, the port's own: YaRN's frequencies and
the interleaved-pair rotation of DeepSeek-V2's latent attention
(``nn/mla.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    # a Python-number base: a tensor made on the card from a host scalar
    # would be a blocking copy on every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, head_dim); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- YaRN, interleaved pairs
def yarn_inv_freq(dim: int, theta: float, yarn) -> np.ndarray:
    """The (dim/2,) float64 inverse frequencies of a rotary part of
    ``dim``: ``theta^(-2j/dim)``, and with ``yarn`` (a ``configs.YaRN``)
    those divided by ``yarn.factor`` blended in over the correction range
    (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``): ramp_j = clamp((j -
    low) / (high - low), 0, 1), inv_j = freq_j (1 - ramp_j) + freq_j /
    factor * ramp_j, where low and high are the dimensions that turn
    ``beta_fast`` and ``beta_slow`` times over ``original_max_position``,
    floored and ceiled."""
    freq = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    if yarn is None:
        return freq

    def dim_of(rotations: float) -> float:
        return dim * math.log(yarn.original_max_position
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(dim_of(yarn.beta_fast)), 0)
    high = min(math.ceil(dim_of(yarn.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / (high - low), 0.0, 1.0)
    return freq * (1.0 - ramp) + freq / yarn.factor * ramp


def rope_rotations(inv_freq: np.ndarray, n: int, device,
                   attn_factor: float = 1.0) -> torch.Tensor:
    """The (n, dim/2) complex64 rotations of positions 0 .. n-1 by the
    float64 ``inv_freq``: attn_factor (cos + i sin) of each angle, taken
    in float64 and rounded once (YaRN's table scale is ``attn_factor``)."""
    ang = np.arange(n, dtype=np.float64)[:, None] * inv_freq
    rot = attn_factor * np.exp(1j * ang)
    return torch.from_numpy(rot.astype(np.complex64)).to(device)


def apply_rope_pairs(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (2i, 2i + 1) of ``x`` (..., dim) by the complex
    ``rot`` (broadcastable to (..., dim/2)): DeepSeek-V2's published
    layout, whose ``apply_rotary_pos_emb`` gathers the even and odd
    entries and rotates them as halves (the port keeps the pairs in
    place: a dot product of two rotated vectors is the same either way).
    The product runs in float32."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * rot).flatten(-2).to(x.dtype)
