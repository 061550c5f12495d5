"""The decode step as one CUDA graph (``launch/steps.py`` ``DecodeGraph``)
and ``decode_attention`` reading its position from device memory, on a
card: the kernel at a device position against the same kernel at an int
position, bit for bit at equal splits (empty splits included); a replayed
graph step against the eager step; ``Server.generate`` with and without
the graph; the profiler seeing the kernels a replay launches. Every test is
marked ``cuda`` and skips without a CUDA device; this file imports no JAX,
so on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph_cuda.py
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn.layers import strict_matmul  # noqa: E402

# tests/test_kernels.py's bf16 attention tolerance, relative to the
# largest output
RTOL = 3e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    strict_matmul()
    return torch.device("cuda")


def _inputs(seed, B, Hq, Hkv, cap, hd):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda")
                 .to(torch.bfloat16)
                 for shape in ((B, Hq, hd), (B, Hkv, cap, hd),
                               (B, Hkv, cap, hd)))


def _at(pos: int):
    return torch.full((1,), pos, dtype=torch.int32, device="cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,positions,splits", [
    # the kernel table's rows: batch2k's last step, one split ...
    ((48, 40, 8, 2176, 128), None, (0, 63, 2047, 2175), (1, 3)),
    # ... and a long cache at a small batch, split in 17: at a short
    # position most splits hold no tile
    ((2, 40, 8, 32768, 128), None, (5, 100, 4095, 32767), (17, 1, 7)),
    # gemma3's local window
    ((2, 32, 16, 4200, 128), 1024, (1000, 1023, 1024, 4199), (1, 5)),
])
def test_device_position_is_the_int_position(cuda_device, shape, window,
                                             positions, splits):
    """At equal splits the kernel reading the position from memory gives
    the int route's output to the bit; at the split count a device
    position takes (the capacity's), it stays within the plain version's
    tolerance."""
    q, k, v = _inputs(sum(shape), *shape)
    B, Hq, Hkv, cap, hd = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = cuda_da.split_count(torch.bfloat16, B, Hq, Hkv, hd,
                                 cuda_da.attended(cap - 1, window)[1], sms)
    for pos in positions:
        want = ref.decode_attention(q, k, v, pos, window=window)
        for n in splits + (chosen,):
            at_int = cuda_da.decode_attention(q, k, v, pos, window=window,
                                              splits=n)
            on_device = cuda_da.decode_attention(q, k, v, _at(pos),
                                                 window=window, splits=n)
            assert torch.equal(on_device, at_int), (pos, n)
        got = cuda_da.decode_attention(q, k, v, _at(pos), window=window)
        assert _rel(got, want) <= RTOL, pos


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [-1, 2176, 1 << 30])
def test_position_outside_the_cache_reads_nothing(cuda_device, pos):
    """The wrapper refuses such an int; written to the device, where the
    host's check of the decode step stands before it, the kernel reads
    no key or value and every output is NaN."""
    q, k, v = _inputs(1, 4, 40, 8, 2176, 128)
    with pytest.raises(ValueError, match="outside"):
        cuda_da.decode_attention(q, k, v, pos)
    for splits in (1, 3):
        out = cuda_da.decode_attention(q, k, v, _at(pos), splits=splits)
        torch.cuda.synchronize()
        assert bool(torch.isnan(out.float()).all())


def _model(arch="qwen2.5-14b", B=4, P=48, gen=24):
    cfg = reduced(get_config(arch))
    g = torch.Generator(device="cuda").manual_seed(0)
    model = tf.init_params(cfg, g, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).cuda()
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, prompts, capacity=P + gen)
    return cfg, model, logits, cache


def _leaves(cfg, cache):
    return [t for c in tf.layer_caches(cfg, cache) for t in c.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-27b"])
def test_replayed_graph_step_is_the_eager_step(cuda_device, arch):
    """24 steps from a 48-token prompt (positions 48-71: the reduced
    model's head dim 16 takes tiles of 64 positions, so the range grows a
    tile at 64): one capture, then replays, each step's logits and the
    caches after equal to the eager step's."""
    cfg, model, logits, cache = _model(arch)
    eager_cache = copy.deepcopy(cache)
    graphed = steps.make_decode_step(cfg)
    eager = steps.make_decode_step(cfg, graph=False)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    ops.reset_launch_counts()
    with torch.inference_mode():
        for t in range(24):
            want, eager_cache = eager(model, eager_cache, tok, 48 + t)
            got, cache = graphed(model, cache, tok, 48 + t)
            assert torch.equal(got, want), t
            tok = torch.argmax(want[:, 0], dim=-1).to(torch.int32)[:, None]
    counts = ops.graph_counts()
    assert counts["decode_graph.captures"] == 1
    assert counts["decode_graph.replays"] == 24
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cfg, cache),
                                                 _leaves(cfg, eager_cache)))


@pytest.mark.cuda
def test_server_generate_with_and_without_the_graph(cuda_device):
    """Reduced qwen2.5-14b through ``Server.generate``: the same 16 greedy
    tokens on the graph as on the eager step; one capture and 16 replays
    a call, ``decode_attention`` issued twice a layer (the warm-up and the
    capture); later calls capture anew where their caches lie elsewhere,
    into the same pool, so the card's memory does not grow call by
    call."""
    from repro_torch.launch.serve import Server

    cfg = reduced(get_config("qwen2.5-14b"))
    g = torch.Generator(device="cuda").manual_seed(0)
    server = Server(cfg, tf.init_params(cfg, g, "cuda"))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    ops.reset_launch_counts()
    graphed = server.generate(prompts, 16)
    counts = ops.launch_counts() | ops.graph_counts()
    assert counts["decode_graph.captures"] == 1
    assert counts["decode_graph.replays"] == 16
    assert counts["decode_attention"] == 2 * cfg.num_layers
    after = []
    for _ in range(3):
        np.testing.assert_array_equal(server.generate(prompts, 16), graphed)
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[2] == after[1], after
    assert ops.graph_counts()["decode_graph.replays"] == 64
    server.decode = steps.make_decode_step(cfg, graph=False)
    ops.reset_launch_counts()
    np.testing.assert_array_equal(server.generate(prompts, 16), graphed)
    counts = ops.launch_counts() | ops.graph_counts()
    assert counts["decode_graph.captures"] == 0
    assert counts["decode_attention"] == 16 * cfg.num_layers


@pytest.mark.cuda
def test_profiler_records_the_replayed_kernels(cuda_device):
    """A capture and 7 replays under ``torch.profiler``: the trace holds
    a ``decode_attention`` kernel a layer and replay (what
    ``decode_attention_roofline`` reads), and one ``Model.decode`` span a
    step, the first captured."""
    from repro_torch import trace

    cfg, model, logits, cache = _model(gen=8)
    step = steps.make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    trace.clear()
    with torch.inference_mode(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for t in range(8):
            logits, cache = step(model, cache, tok, 48 + t)
        torch.cuda.synchronize()
    spans = [s for s in trace.spans() if s.name == "Model.decode"]
    assert [(s.attrs["route"], s.attrs["captured"]) for s in spans] \
        == [("graph", True)] + [("graph", False)] * 7
    kernels = sum(e.count for e in prof.key_averages()
                  if "decode_attention_kernel" in e.key)
    # the warm-up's launches, and one a layer in each of the 8 replays
    assert kernels >= cfg.num_layers * 8, kernels
