"""The port's ``flash_attention`` and attention module against the JAX
package.

On the CPU the port's dispatcher takes the plain full-softmax version
(``repro_torch.kernels.ref.flash_attention``); it must give the Pallas
kernel's answers (interpret mode) within 2e-4 in float32 and 3e-2 in
bfloat16 (``tests/test_kernels.py``). ``attn_forward``'s plain route is
the reference's blocked path, ported; its kernel route is checked here by
standing the plain full softmax in for the CUDA kernel, which shows that
the route hands the kernel the window the reference path uses. The CUDA
kernel itself is compared with the plain version in
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import load_tree  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402


def _qkv(rng, B, Hq, Hkv, S, hd, dtype=np.float32):
    q = rng.standard_normal((B, Hq, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window", [
    (1, 2, 2, 128, 16, None),      # causal, MHA
    (2, 4, 2, 128, 64, None),      # GQA, Hq / Hkv = 2
    (1, 4, 1, 128, 16, None),      # one kv head
    (1, 2, 2, 256, 16, 32),        # window 32
    (1, 4, 1, 128, 64, 64),        # window 64, one kv head
])
def test_flash_attention_matches_pallas(B, Hq, Hkv, S, hd, window):
    q, k, v = _qkv(np.random.default_rng(S + Hq + hd), B, Hq, Hkv, S, hd)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window, q_block=64, kv_block=64,
                        interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_flash_attention_bf16_matches_pallas():
    q, k, v = _qkv(np.random.default_rng(9), 1, 2, 1, 128, 32)
    j = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want = pallas_flash(*j, causal=True, q_block=64, kv_block=64,
                        interpret=True)
    got = ops.flash_attention(*t, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_flash_attention_use_kernel_true_on_cpu_raises():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, use_kernel=True)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fa.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 0


# ------------------------------------------------------------ the module
@pytest.fixture(scope="module")
def cfgs():
    """Reduced recurrentgemma-2b: local window 8, kv_chunk 16, 4 query
    heads over 1 kv head of width 16."""
    return (ref_reduced(ref_get_config("recurrentgemma-2b")),
            reduced(get_config("recurrentgemma-2b")))


@pytest.fixture(scope="module")
def layer(cfgs):
    jcfg, cfg = cfgs
    tree = jax.tree.map(np.asarray,
                        jattn.init_attn(jax.random.PRNGKey(1), jcfg))
    return tree, load_tree(attn.Attention(cfg, "cpu"), tree)


def _inputs(cfg, S, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    return x, pos


def _reference(tree, x, jcfg, kind, pos):
    """The reference's attn_forward, or the TypeError it raises."""
    try:
        return jattn.attn_forward(tree, jnp.asarray(x), jcfg, kind,
                                  jnp.asarray(pos), return_kv=True)
    except TypeError as exc:
        return exc


@pytest.fixture
def kernel_route(monkeypatch):
    """Route attn_forward through its kernel branch, with the plain full
    softmax standing in for the CUDA kernel; records each call's window."""
    calls = []

    def flash(q, k, v, *, causal, window, use_kernel):
        calls.append(window)
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(attn, "ops", types.SimpleNamespace(
        wants_kernel=lambda t, use_kernel: use_kernel is not False,
        flash_attention=flash))
    return calls


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("kind,S", [("local", 8), ("local", 32),
                                    ("local", 40), ("attn", 8),
                                    ("attn", 32), ("attn", 40)])
def test_attn_forward_matches_reference(cfgs, layer, request, route, kind,
                                        S):
    """S = 40 for ``attn`` is longer than kv_chunk and not a multiple of
    it: the reference raises TypeError, and so does the port."""
    jcfg, cfg = cfgs
    tree, p = layer
    calls = request.getfixturevalue("kernel_route") if route == "kernel" \
        else None
    x, pos = _inputs(cfg, S)
    want = _reference(tree, x, jcfg, kind, pos)
    if isinstance(want, TypeError):
        assert kind == "attn" and S == 40
        with pytest.raises(TypeError):
            attn.attn_forward(p, torch.from_numpy(x), cfg, kind,
                              torch.from_numpy(pos))
        return
    got, kv = attn.attn_forward(p, torch.from_numpy(x), cfg, kind,
                                torch.from_numpy(pos), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=1e-5,
                               rtol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(want[1][name]),
                                   atol=1e-5, rtol=1e-5)
    if calls is not None:
        windowed = kind == "local" and S > cfg.local_window
        assert calls == [cfg.local_window if windowed else None]


def test_window_fallback_quirk_s12(cfgs, layer, kernel_route):
    """S = 12 > window 8 but not a multiple of it: the reference falls back
    to full causal attention, which ignores the window. The port matches
    on both routes (the kernel gets window=None), and the result is far
    (a thousand times the tolerance) from true windowed attention."""
    jcfg, cfg = cfgs
    tree, p = layer
    x, pos = _inputs(cfg, 12, seed=4)
    want = np.asarray(jattn.attn_forward(tree, jnp.asarray(x), jcfg,
                                         "local", jnp.asarray(pos)))
    for use_kernel in (False, None):
        got = attn.attn_forward(p, torch.from_numpy(x), cfg, "local",
                                torch.from_numpy(pos), use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert kernel_route == [None]
    q, k, v = attn._project_qkv(p, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos))
    windowed = ref.flash_attention(q, k, v, causal=True,
                                   window=cfg.local_window)
    full = ref.flash_attention(q, k, v, causal=True)
    assert float((windowed - full).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_ragged_chunk_raises_s20(cfgs, layer, kind):
    """S = 20 > kv_chunk 16, not a multiple: the reference drops the tail
    block and its reshape raises TypeError; the port raises TypeError."""
    jcfg, cfg = cfgs
    tree, p = layer
    x, pos = _inputs(cfg, 20)
    assert isinstance(_reference(tree, x, jcfg, kind, pos), TypeError)
    with pytest.raises(TypeError):
        attn.attn_forward(p, torch.from_numpy(x), cfg, kind,
                          torch.from_numpy(pos))


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_attn_decode_matches_reference(cfgs, layer, kind):
    jcfg, cfg = cfgs
    tree, p = layer
    rng = np.random.default_rng(11)
    cap = 24
    shape = (2, cfg.n_kv_heads, cap, cfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    tcache = {"k": torch.tensor(ck), "v": torch.tensor(cv)}
    for pos in (3, 12, 20):          # window 8: the last two mask the past
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jattn.attn_decode(tree, jnp.asarray(x), jcfg, kind,
                                         jcache, pos)
        got, tcache = attn.attn_decode(p, torch.from_numpy(x), cfg, kind,
                                       tcache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), atol=1e-5,
                                       rtol=1e-5)
