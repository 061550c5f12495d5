"""Faults to plant in the program under a DeepSeek-V2 generation cell, each
a context manager that patches the port while it is open: what the cell's
check (``generate_mla.numbers``) has to catch. The CPU tests plant each
one and see ``correct`` come out false; ``calibrate_mla.py --faults``
reads them on the card at the cell's own size.

Each patches a function of ``nn/mla.py`` or ``nn/moe.py`` that both the
prefill and the decode step call through the module, so that it acts on
the CPU's plain route and on the card's kernel route alike.
"""
from __future__ import annotations

import torch

from benchlib.model_faults import _patched, token_altered


def causal_off():
    """The prefill's attention with the causal mask off."""
    from repro_torch.nn import mla

    real = mla._attend

    def attend(q, k, v, scale, causal=True, use_kernel=None):
        return real(q, k, v, scale, causal=False, use_kernel=use_kernel)

    return _patched(mla, "_attend", attend)


def latent_norm_skipped():
    """The latent c taken as it leaves W_kva, without its RMSNorm."""
    from repro_torch.nn import mla

    return _patched(mla, "rms_norm", lambda x, scale, eps=1e-6: x)


def half_rotation_rope():
    """The rotated parts turned as halves (pairs (i, i + Rp/2), the
    LLaMA layout), not as the published (2i, 2i + 1) pairs."""
    from repro_torch.nn import mla

    def rotate(x, rot):
        cos, sin = rot.real, rot.imag
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return _patched(mla, "apply_rope_pairs", rotate)


def yarn_off():
    """Plain rotary frequencies, YaRN's blend left out."""
    import dataclasses

    from repro_torch.nn import mla

    real = mla.rope_tables

    def tables(cfg, positions, device=None):
        return real(dataclasses.replace(cfg, rope_scaling=None), positions,
                    device)

    return _patched(mla, "rope_tables", tables)


def mscale_dropped():
    """Scores scaled by (N + Rp)^-1/2 alone, without YaRN's m^2."""
    from repro_torch.nn import mla

    return _patched(mla, "softmax_scale", lambda cfg: (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5)


def shared_experts_dropped():
    """The MoE layers without their shared experts."""
    import dataclasses

    from repro_torch.nn import moe

    real = moe.moe_dropless

    def dropless(p, x, cfg):
        return real(p, x, dataclasses.replace(cfg, n_shared_experts=0))

    return _patched(moe, "moe_dropless", dropless)


def topk_renormalised():
    """The top-k weights renormalised to sum to one."""
    import dataclasses

    from repro_torch.nn import moe

    real = moe._dropless_routing

    def routing(p, x, cfg):
        return real(p, x, dataclasses.replace(cfg, norm_topk_prob=True))

    return _patched(moe, "_dropless_routing", routing)


def seventh_over_sixth():
    """Each token's k-th expert replaced by its (k+1)-th, with that
    expert's weight."""
    from repro_torch.nn import moe

    real = moe._top_k

    def top_k(x, k):
        w, idx = real(x, k + 1)
        keep = list(range(k - 1)) + [k]
        return w[..., keep], idx[..., keep]

    return _patched(moe, "_top_k", top_k)


def latent_cache_unwritten():
    """A decode step that leaves the latent cache as it found it: the
    step's latent and rotated key are never written."""
    from repro_torch.nn import mla

    real = mla.mla_decode

    def decode(p, x, cfg, cache, pos):
        kept = cache["latent"][:, pos].clone()
        y, cache = real(p, x, cfg, cache, pos)
        cache["latent"][:, pos] = kept
        return y, cache

    return _patched(mla, "mla_decode", decode)


FAULTS = {"causal_off": causal_off,
          "latent_norm_skipped": latent_norm_skipped,
          "half_rotation_rope": half_rotation_rope, "yarn_off": yarn_off,
          "mscale_dropped": mscale_dropped,
          "shared_experts_dropped": shared_experts_dropped,
          "topk_renormalised": topk_renormalised,
          "seventh_over_sixth": seventh_over_sixth,
          "latent_cache_unwritten": latent_cache_unwritten,
          "token_altered": token_altered}
