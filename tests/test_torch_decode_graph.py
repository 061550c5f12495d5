"""The decode step's position as device data, and which models take the
decode step's CUDA graph (``launch/steps.py``), on the CPU.

The graph itself needs a card (``tests/test_torch_decode_graph_cuda.py``).
Here: the step fed its position as a (B, 1) int32 tensor gives, to the
bit, the logits and caches of the eager step that took the position as a
Python int (the port's step before the position moved to the device,
written out below), on the reduced qwen2.5-14b and on gemma3's windowed
local layers; the rule that picks the graph from the configuration; the
host's check of the position; and the ``decode_attention`` wrapper's
device-position arguments on meta tensors.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn.layers import apply_norm, dense  # noqa: E402

GRAPH = ("qwen2.5-14b", "starcoder2-7b", "gemma3-27b")
EAGER = ("deepseek-v2-lite", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b",
         "recurrentgemma-2b", "xlstm-1.3b")
STEPS = 8


def _int_attn_decode(p, x, cfg, kind, cache, pos: int):
    """``attn_decode`` as it was while the position was a host int, line
    for line: positions rebuilt from ``pos``, the cache written by a slice
    at ``pos``, the attention's mask from the int."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn._project_qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, pos:pos + 1] = k.to(ck.dtype)
    cv[:, :, pos:pos + 1] = v.to(cv.dtype)
    out = ref.decode_attention(q[:, :, 0], ck, cv, pos,
                               window=attn.window_for(kind, cfg))
    y = dense(out.reshape(B, 1, cfg.q_dim).to(x.dtype), p.wo)
    return y, {"k": ck, "v": cv}


def _int_decode_step(model, cfg, cache, inputs, pos: int):
    """``models.transformer.decode_step`` of an attention model as it was
    while the position was a host int."""
    B = inputs.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=model.device)
    x = tf.embed_inputs(model, cfg, inputs, positions)
    for (block, kind), c in zip(model.blocks(), tf.layer_caches(cfg, cache)):
        h = apply_norm(block.norm1, x, cfg.norm)
        h, _ = _int_attn_decode(block.mixer, h, cfg, kind, c, pos)
        x, _ = tf._ffn_residual(block, tf._mixer_residual(block, x, h, cfg),
                                cfg, kind)
    x = apply_norm(model.final_norm, x, cfg.norm)
    return tf.logits_fn(model, cfg, x), cache


def _prefilled(arch: str, B: int, P: int):
    cfg = reduced(get_config(arch))
    g = torch.Generator().manual_seed(7)
    model = tf.init_params(cfg, g, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, prompts, capacity=P + STEPS)
    return cfg, model, logits, cache


def _leaves(cfg, cache):
    return [t for c in tf.layer_caches(cfg, cache) for t in c.values()]


@pytest.mark.parametrize("arch,P", [("qwen2.5-14b", 12),
                                    # local window 8: every step's range
                                    # starts past position 0
                                    ("gemma3-27b", 16)])
def test_device_position_step_equals_the_int_position_step(arch, P):
    """8 consecutive decode steps: the int-position step (the parent's
    arithmetic), the step at an int now, and the step fed its (B, 1)
    device positions give the same logits and caches, to the bit."""
    cfg, model, logits, cache = _prefilled(arch, 3, P)
    caches = [cache, copy.deepcopy(cache), copy.deepcopy(cache)]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    with torch.inference_mode():
        for t in range(STEPS):
            pos = P + t
            positions = torch.full((3, 1), pos, dtype=torch.int32)
            want, caches[0] = _int_decode_step(model, cfg, caches[0], tok,
                                               pos)
            at_int, caches[1] = tf.decode_step(model, cfg, caches[1], tok,
                                               pos)
            on_device, caches[2] = tf.decode_step(model, cfg, caches[2], tok,
                                                  positions)
            assert torch.equal(at_int, want) and torch.equal(on_device, want)
            tok = torch.argmax(want[:, 0], dim=-1).to(torch.int32)[:, None]
    base = _leaves(cfg, caches[0])
    for other in caches[1:]:
        assert all(torch.equal(a, b) for a, b in zip(base, _leaves(cfg,
                                                                   other)))


@pytest.mark.parametrize("window,pos", [(None, 0), (None, 23), (8, 5),
                                        (8, 20)])
def test_plain_attention_takes_the_position_as_a_tensor(window, pos):
    g = torch.Generator().manual_seed(pos)
    q = torch.randn((2, 10, 16), generator=g)
    k = torch.randn((2, 2, 24, 16), generator=g)
    v = torch.randn((2, 2, 24, 16), generator=g)
    at = torch.tensor([pos], dtype=torch.int32)
    assert torch.equal(ref.decode_attention(q, k, v, at, window=window),
                       ref.decode_attention(q, k, v, pos, window=window))


@pytest.mark.parametrize("arch", GRAPH + EAGER)
def test_graph_rule_follows_the_configuration(arch):
    """The graph for a model of attention layers with dense feed-forwards
    on a card; the eager step for latent attention, MoE feed-forwards and
    recurrent mixers, and on the CPU for every model."""
    cfg = get_config(arch)
    assert steps.takes_graph(cfg, "cuda") is (arch in GRAPH)
    assert steps.takes_graph(reduced(cfg), torch.device("cuda")) \
        is (arch in GRAPH)
    assert not steps.takes_graph(cfg, "cpu")


def test_step_on_the_cpu_is_eager_and_spanned():
    """On the CPU the step the graph rule admits runs eagerly: no capture
    or replay counted, and under a profiler one ``Model.decode`` span a
    step with ``route`` "eager"."""
    cfg, model, logits, cache = _prefilled("qwen2.5-14b", 2, 12)
    step = steps.make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    ops.reset_launch_counts()
    trace.clear()
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for t in range(3):
            _, cache = step(model, cache, tok, 12 + t)
    spans = [s for s in trace.spans() if s.name == "Model.decode"]
    assert [(s.attrs["route"], s.attrs["captured"]) for s in spans] \
        == [("eager", False)] * 3
    counts = ops.graph_counts()
    assert counts["decode_graph.captures"] == 0
    assert counts["decode_graph.replays"] == 0


@pytest.mark.parametrize("arch,pos", [("qwen2.5-14b", -1),
                                      ("qwen2.5-14b", 12 + STEPS),
                                      ("qwen2.5-14b", 10_000),
                                      ("deepseek-v2-lite", 12 + STEPS),
                                      ("xlstm-1.3b", -1)])
def test_host_check_refuses_a_position_outside_the_cache(arch, pos):
    """A position below 0 or at or past the caches' capacity is refused on
    the host before it reaches the device, and the cache is left as it
    was; a recurrent model's caches hold no positions, so only a negative
    one is refused there."""
    cfg, model, logits, cache = _prefilled(arch, 2, 12)
    before = [t.clone() for t in _leaves(cfg, cache)]
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="outside the cache"):
            steps.make_decode_step(cfg)(model, cache, tok, pos)
        with pytest.raises(ValueError, match="outside the cache"):
            tf.check_position(cfg, cache, pos)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(cfg,
                                                                 cache)))


def test_only_attention_layers_take_a_device_position():
    cfg, model, logits, cache = _prefilled("recurrentgemma-2b", 2, 12)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="device data"):
        tf.decode_step(model, cfg, cache, tok,
                       torch.full((2, 1), 12, dtype=torch.int32))


def _meta(cap=40, hd=128):
    return (torch.empty((2, 40, hd), dtype=torch.bfloat16, device="meta"),
            torch.empty((2, 8, cap, hd), dtype=torch.bfloat16, device="meta"),
            torch.empty((2, 8, cap, hd), dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("pos", [torch.zeros(1, dtype=torch.int64,
                                             device="meta"),
                                 torch.zeros(2, dtype=torch.int32,
                                             device="meta"),
                                 torch.zeros(1, dtype=torch.int32)])
def test_wrapper_refuses_a_device_position_it_cannot_read(pos):
    """Not int32, not one element, or not on q's device."""
    q, k, v = _meta()
    with pytest.raises(ValueError, match="pos"):
        cuda_da.decode_attention(q, k, v, pos)


@pytest.mark.parametrize("window,length", [(None, 40), (16, 16)])
def test_meta_count_of_a_device_position_is_the_longest_range(window,
                                                              length):
    """The work a device position may cost, counted for the dry-run: the
    range at the cache's last position, as the split count is chosen."""
    from repro_torch.analysis import hlo

    q, k, v = _meta()
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with hlo.OpCounter() as counter:
        out = cuda_da.decode_attention(q, k, v, pos, window=window)
    assert out.shape == q.shape and counter.kernels["decode_attention"] == 1
    assert counter.kernel_bytes \
        == cuda_da.work(2, 40, 8, length, 128, 2)["hbm_bytes"]
