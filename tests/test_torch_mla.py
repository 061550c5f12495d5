"""CPU tests of the port's DeepSeek-V2: latent attention (``nn/mla.py``),
the dropless MoE dispatch with shared experts (``nn/moe.py``), YaRN
(``nn/rope.py``) and the latent cache through ``models/transformer.py``.

The reference is the benchmark's plain float32 DeepSeek-V2
(``bench/benchlib/deepseek_v2_reference.py``), which imports nothing of
the port, on the weights ``deepseek_v2_weights.py`` draws; the model is a
reduced ``deepseek-v2-lite``: 3 layers (1 dense, 2 MoE), hidden 64, 4
heads, latent 32, nope / rope / v 16 / 8 / 16, 8 experts top-2 with 2
shared, a vocabulary of 256, float32 on the CPU.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from benchlib import deepseek_v2_reference as dref  # noqa: E402
from benchlib import generate_mla  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import mla, moe  # noqa: E402
from repro_torch.nn.layers import apply_norm  # noqa: E402
from repro_torch.nn.rope import yarn_inv_freq  # noqa: E402

SEED = 2**31 + 11
TOL = 1e-5


def tiny_config() -> dict:
    """The benchmark configuration of ``deepseek-v2-lite`` at the reduced
    sizes."""
    cfg = json.loads((ROOT / "bench" / "configs" / "deepseek-v2-lite.json")
                     .read_text())
    return dict(copy.deepcopy(cfg), num_hidden_layers=3, hidden_size=64,
                num_attention_heads=4, num_key_value_heads=4,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                intermediate_size=128, moe_intermediate_size=64,
                vocab_size=256)


@pytest.fixture(scope="module")
def served():
    """(configuration, server) of the reduced model on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = tiny_config()
    yield cfg, generate_mla.model_server(cfg, SEED, "cpu")
    torch.set_num_threads(threads)


def _tokens(n: int, t: int, seed: int = 3) -> torch.Tensor:
    return torch.randint(0, 256, (n, t),
                         generator=torch.Generator().manual_seed(seed))


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def case_prefill_logits(cfg, server):
    """The whole forward (prefill's path, every position) against the
    reference, which routes itself: no choice differs in float32."""
    tok = _tokens(3, 40)
    with torch.no_grad():
        h, _ = tf.forward(server.params, server.cfg, tok,
                          torch.arange(40)[None].expand(3, 40))
        got = tf.logits_fn(server.params, server.cfg, h)
        lg, _ = tf.prefill(server.params, server.cfg, tok)
    ref = dref.run(cfg, SEED, tok, 0)
    assert _rel(got, ref["logits"]) < TOL
    assert _rel(lg[:, 0], ref["logits"][:, -1]) < TOL
    assert ref["route_flip_share"] == 0.0
    # the dense layer over the tokens in groups (of 7, the last ragged)
    old = tf.FFN_TOKENS
    try:
        tf.FFN_TOKENS = 7
        with torch.no_grad():
            grouped, _ = tf.prefill(server.params, server.cfg, tok)
    finally:
        tf.FFN_TOKENS = old
    assert _rel(grouped, lg) < TOL


def case_decode_through_latent_cache(cfg, server):
    """A prefill of 32 tokens, then 4 decode steps through the latent
    cache, against the reference's full forward over the 36."""
    tok = _tokens(2, 36, seed=4)
    ref = dref.run(cfg, SEED, tok, 31)["logits"]
    with torch.no_grad():
        lg, cache = tf.prefill(server.params, server.cfg, tok[:, :32],
                               capacity=36)
        assert set(tf.layer_caches(server.cfg, cache)[0]) == {"latent"}
        assert _rel(lg[:, 0], ref[:, 0]) < TOL
        for t in range(32, 36):
            lg, cache = tf.decode_step(server.params, server.cfg, cache,
                                       tok[:, t:t + 1], t)
            assert _rel(lg[:, 0], ref[:, t - 31]) < TOL, t


def _loop_moe(p, x, cfg):
    """A per-token loop over the chosen experts: the softmax, the top k,
    the weights, each expert's SwiGLU, the shared experts."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        probs = torch.softmax(x[t] @ p.router, dim=-1)
        w, idx = torch.sort(probs, descending=True, stable=True)
        w, idx = w[:cfg.top_k], idx[:cfg.top_k]
        if cfg.norm_topk_prob:
            w = w / w.sum()
        for wk, e in zip(w, idx.tolist()):
            h = torch.nn.functional.silu(x[t] @ p.w1[e]) * (x[t] @ p.w3[e])
            out[t] += wk * (h @ p.w2[e])
        if cfg.n_shared_experts:
            s = p.shared
            out[t] += (torch.nn.functional.silu(x[t] @ s.w1)
                       * (x[t] @ s.w3)) @ s.w2
    return out


def _dropless_against_loop(mcfg):
    model = tf.init_params(mcfg, torch.Generator().manual_seed(7), "cpu")
    block = next(b for b, _ in model.blocks() if isinstance(b.ffn, moe.MoE))
    x = torch.randn(3, 11, mcfg.d_model,
                    generator=torch.Generator().manual_seed(8))
    want = _loop_moe(block.ffn, x.reshape(-1, mcfg.d_model), mcfg)
    old = moe.DROPLESS_TOKENS, moe.FEW_TOKENS
    # the grouped products in groups of 7 tokens (the last ragged), then
    # every expert over the 33 tokens
    for groups, few in ((7, 0), (old[0], 64)):
        try:
            moe.DROPLESS_TOKENS, moe.FEW_TOKENS = groups, few
            with torch.no_grad():
                y, _ = moe.moe_dropless(block.ffn, x, mcfg)
        finally:
            moe.DROPLESS_TOKENS, moe.FEW_TOKENS = old
        assert _rel(y.reshape(-1, mcfg.d_model), want) < TOL, few
    assert int(block.ffn.load.sum()) == 2 * 33 * mcfg.top_k


def case_dropless_deepseek(cfg, server):
    _dropless_against_loop(server.cfg)


def case_dropless_mixtral(cfg, server):
    _dropless_against_loop(reduced(get_config("mixtral-8x22b"),
                                   moe_impl="dropless"))


def case_dropless_phi35(cfg, server):
    _dropless_against_loop(reduced(get_config("phi3.5-moe-42b-a6.6b"),
                                   moe_impl="dropless"))


def case_yarn_tables(cfg, server):
    """The full-size model's YaRN frequencies and scale against the float64
    formula: freq_j = 10000^(-2j/64), ramp_j = clamp((j - 10) / 13, 0, 1),
    inv_j = freq_j (1 - ramp_j) + freq_j / 40 ramp_j; the softmax scale
    192^-1/2 (0.1 x 0.707 x ln 40 + 1)^2."""
    full = get_config("deepseek-v2-lite")
    j = np.arange(32, dtype=np.float64)
    freq = 10000.0 ** (-2 * j / 64)
    ramp = np.clip((j - 10) / 13, 0, 1)
    want = freq * (1 - ramp) + freq / 40 * ramp
    np.testing.assert_allclose(yarn_inv_freq(64, 1e4, full.rope_scaling),
                               want, rtol=1e-15)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla.softmax_scale(full) == pytest.approx(192 ** -0.5 * m * m,
                                                    rel=1e-12)
    assert round(mla.softmax_scale(full), 6) == 0.114721
    rot = mla.rope_tables(full, torch.arange(16384)[None])[0]
    at = [0, 1, 4095, 16383]
    ang = np.array(at, np.float64)[:, None] * want
    np.testing.assert_allclose(rot[at].real.numpy(), np.cos(ang), atol=1e-7)
    np.testing.assert_allclose(rot[at].imag.numpy(), np.sin(ang), atol=1e-7)
    for p in at:
        assert torch.equal(mla.rope_tables(full, p, "cpu"), rot[p])
    bench = json.loads((ROOT / "bench" / "configs" / "deepseek-v2-lite.json")
                       .read_text())
    np.testing.assert_allclose(dref.yarn_inv_freq(bench, "cpu").numpy(),
                               want, rtol=1e-15)


def case_routing_record(cfg, server):
    """The route hook hands each MoE call's expert ids (B, S, top_k): in a
    prefill and a decode step, each layer's the reference's own top-k;
    the load counters hold the slots per expert."""
    seen = []
    moe.install_route_hook(server.params, lambda layer, ids: seen.append(
        (layer, ids.clone())))
    moes = [m for m in server.params.modules() if isinstance(m, moe.MoE)]
    for m in moes:
        m.load.zero_()
    tok = _tokens(2, 17, seed=5)
    try:
        with torch.no_grad():
            _, cache = tf.prefill(server.params, server.cfg, tok[:, :16],
                                  capacity=17)
            tf.decode_step(server.params, server.cfg, cache, tok[:, 16:],
                           16)
    finally:
        moe.install_route_hook(server.params, None)
    assert [(layer, tuple(ids.shape)) for layer, ids in seen] == [
        (1, (2, 16, 2)), (2, (2, 16, 2)), (1, (2, 1, 2)), (2, (2, 1, 2))]
    ref = dref.run(cfg, SEED, tok, 16)["routes"]            # (2, 2, 17, 2)
    for i, (layer, ids) in enumerate(seen):
        at = slice(0, 16) if i < 2 else slice(16, 17)
        assert torch.equal(ids, ref[layer - 1][:, at]), i
    for m in moes:
        assert int(m.load.sum()) == 17 * 2 * 2
    load = torch.stack([m.load for m in moes])
    want = torch.stack([torch.bincount(ref[i].reshape(-1), minlength=8)
                        for i in range(2)])
    assert torch.equal(load, want)


def case_absorbed_decode(cfg, server):
    """One latent-attention layer: the absorbed decode step over the
    latent cache against the decompressed prefill's last position."""
    mcfg = server.cfg
    block = next(iter(server.params.blocks()))[0]
    x = torch.randn(2, 12, mcfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    h = apply_norm(block.norm1, x, mcfg.norm)
    pos = torch.arange(12)[None].expand(2, 12)
    with torch.no_grad():
        full = mla.mla_forward(block.mixer, h, mcfg, pos)
        _, cache = mla.mla_forward(block.mixer, h[:, :11], mcfg, pos[:, :11],
                                   capacity=12)
        y, cache = mla.mla_decode(block.mixer, h[:, 11:], mcfg, cache, 11)
        _, whole = mla.mla_forward(block.mixer, h, mcfg, pos, capacity=12)
    assert _rel(y[:, 0], full[:, 11]) < TOL
    assert _rel(cache["latent"], whole["latent"]) < TOL


def case_decode_scores_in_float32(cfg, server):
    """The absorbed decode's scores of a bf16 cache come out in float32,
    not rounded to bf16 before the softmax: equal to the float32 product
    of the same bf16 operands."""
    g = torch.Generator().manual_seed(11)
    q = (torch.randn(2, 4, 40, generator=g) * 8).to(torch.bfloat16)
    keys = (torch.randn(2, 30, 40, generator=g) * 8).to(torch.bfloat16)
    got = mla._scores(q, keys)
    want = torch.bmm(q.double(), keys.double().transpose(1, 2))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-6
    assert _rel(got.to(torch.bfloat16).float(), want) > 1e-4


def case_spans(cfg, server):
    """Under a profiler a prefill and a decode step leave ``Model.mla``
    spans (phase, positions) a layer and ``Model.moe`` spans (tokens,
    slots) an MoE layer."""
    from torch.profiler import ProfilerActivity, profile

    tok = _tokens(2, 9, seed=6)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        _, cache = tf.prefill(server.params, server.cfg, tok[:, :8],
                              capacity=9)
        tf.decode_step(server.params, server.cfg, cache, tok[:, 8:], 8)
    got = [(s.name, s.attrs) for s in trace.spans()]
    trace.clear()
    mla_spans = [a for n, a in got if n == "Model.mla"]
    moe_spans = [a for n, a in got if n == "Model.moe"]
    assert mla_spans == 3 * [{"phase": "prefill", "positions": 8}] \
        + 3 * [{"phase": "decode", "positions": 9}]
    assert moe_spans == 2 * [{"tokens": 16, "slots": 32}] \
        + 2 * [{"tokens": 2, "slots": 4}]


CASES = {f.__name__[len("case_"):]: f for f in (
    case_prefill_logits, case_decode_through_latent_cache,
    case_dropless_deepseek, case_dropless_mixtral, case_dropless_phi35,
    case_yarn_tables, case_routing_record, case_absorbed_decode,
    case_decode_scores_in_float32, case_spans)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deepseek_v2(served, case):
    CASES[case](*served)


def test_config_counts_and_defaults():
    """The published sizes and parameter counts: 15.71 B in all; the ten
    reference architectures carry the new fields at their defaults."""
    cfg = get_config("deepseek-v2-lite")
    assert round(cfg.param_count() / 1e9, 2) == 15.71
    assert cfg.layer_kinds() == ["mla"] * 27
    assert [cfg.ffn_kind(i) for i in (0, 1, 26)] == ["swiglu", "moe", "moe"]
    d = 2048
    routed = 64 * 3 * d * 1408
    active = cfg.param_count() - 26 * (routed - 6 * 3 * d * 1408)
    assert cfg.active_param_count() == active
    fields = {f.name: f.default for f in dataclasses.fields(cfg)}
    for name in ("mixtral-8x22b", "qwen2.5-14b"):
        other = get_config(name)
        for k in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                  "v_head_dim", "rope_scaling", "n_shared_experts",
                  "first_k_dense", "norm_topk_prob"):
            assert getattr(other, k) == fields[k], (name, k)
