"""The decode step's attention kernel (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``) on a card: against its plain version,
unsplit and split, bit-stable; refusing a misaligned cache; and through
``Server.generate`` on the reduced qwen2.5-14b, whose greedy tokens the
kernel route must give as the plain route does, one launch a layer and
step. Every test is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention_cuda.py
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402

# tests/test_kernels.py's attention tolerances, relative to the largest
# output
RTOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, B, Hq, Hkv, cap, hd, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Hq, hd), (B, Hkv, cap, hd),
                               (B, Hkv, cap, hd)))


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,window,positions", [
    ((2, 4, 4, 300, 64), None, (0, 150, 299)),        # G 1, hd 64
    ((3, 40, 8, 700, 128), None, (0, 511, 699)),      # G 5, hd 128
    ((2, 10, 1, 1300, 256), 1024, (1022, 1023, 1024, 1299)),  # G 10, window
])
def test_kernel_matches_the_plain_version(cuda_device, dtype, shape, window,
                                          positions):
    q, k, v = _inputs(sum(shape), *shape, dtype)
    for pos in positions:
        want = ref.decode_attention(q, k, v, pos, window=window)
        for splits in (None, 1, 3):
            got = cuda_da.decode_attention(q, k, v, pos, window=window,
                                           splits=splits)
            assert got.dtype == dtype and got.shape == q.shape
            assert _rel(got, want) <= RTOL[dtype], (pos, splits)
        again = cuda_da.decode_attention(q, k, v, pos, window=window)
        assert torch.equal(again, cuda_da.decode_attention(
            q, k, v, pos, window=window))


@pytest.mark.cuda
def test_misaligned_cache_is_refused(cuda_device):
    q, k, v = _inputs(0, 2, 8, 2, 16, 64, torch.bfloat16)
    buf = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(k.shape)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        cuda_da.decode_attention(q, shifted, v, 3)
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.cuda
def test_server_generate_gives_the_plain_routes_tokens(cuda_device,
                                                       monkeypatch):
    """Reduced qwen2.5-14b through ``Server.generate`` on the eager decode
    step (the CUDA graph's issues are counted in
    ``test_torch_decode_graph_cuda.py``): 16 greedy tokens of 4 prompts on
    the kernel route, one ``decode_attention`` launch per layer and step,
    and the same tokens with ``attn_decode`` held to its plain route."""
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf

    cfg = reduced(get_config("qwen2.5-14b"))
    g = torch.Generator(device="cuda").manual_seed(0)
    model = tf.init_params(cfg, g, "cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    server = Server(cfg, model)
    server.decode = make_decode_step(cfg, graph=False)
    ops.reset_launch_counts()
    kernel = server.generate(prompts, 16)
    assert ops.launch_counts()["decode_attention"] == cfg.num_layers * 16
    monkeypatch.setattr(attn, "attn_decode", functools.partial(
        attn.attn_decode, use_kernel=False))
    plain = server.generate(prompts, 16)
    assert ops.launch_counts()["decode_attention"] == cfg.num_layers * 16
    np.testing.assert_array_equal(kernel, plain)
