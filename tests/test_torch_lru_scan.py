"""The port's ``lru_scan`` and RG-LRU block against the JAX package.

On the CPU the port's dispatcher takes the plain sequential loop
(``repro_torch.kernels.ref.lru_scan``); it must give the Pallas kernel's
answers (run in interpret mode) within ``tests/test_kernels.py``'s
tolerances, atol 1e-5 and rtol 1e-4. The CUDA kernel itself is compared
with the plain version in ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lru_scan import lru_scan as pallas_lru_scan  # noqa: E402
from repro.nn import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import lru_scan as cuda_lru  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import load_tree  # noqa: E402
from repro_torch.nn import recurrent as rec  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4


def _coeffs(rng, B, S, C):
    a = rng.uniform(0.5, 0.999, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,C", [(1, 64, 32), (2, 100, 16), (3, 8, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_pallas(B, S, C, with_h0):
    """S = 100 is not a multiple of the reference's time chunk (32 here):
    the reference pads, the port takes any S."""
    rng = np.random.default_rng(B * S + C)
    a, b = _coeffs(rng, B, S, C)
    h0 = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    want = pallas_lru_scan(jnp.asarray(a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0),
                           channel_block=C, time_chunk=32,
                           interpret=True)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                       None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if h0 is None:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jref.lru_scan(jnp.asarray(a),
                                                  jnp.asarray(b))),
            atol=ATOL, rtol=RTOL)


def test_lru_scan_use_kernel_true_on_cpu_raises():
    a = torch.ones((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.lru_scan(a, a, use_kernel=True)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lru.lru_scan(a, a)
    assert ops.launch_counts()["lru_scan"] == 0


# ------------------------------------------------------------ RG-LRU block
@pytest.fixture(scope="module")
def cfgs():
    return (ref_reduced(ref_get_config("recurrentgemma-2b")),
            reduced(get_config("recurrentgemma-2b")))


@pytest.fixture(scope="module")
def block(cfgs):
    jcfg, cfg = cfgs
    tree = jax.tree.map(np.asarray,
                        jrec.init_rglru_block(jax.random.PRNGKey(3), jcfg))
    return tree, load_tree(rec.RGLRU(cfg, "cpu"), tree)


@pytest.mark.parametrize("S", [1, 33])
def test_rglru_forward_matches_reference(cfgs, block, S):
    """The reference's associative scan against the port's sequential
    loop: the sums are taken in another order, so 1e-4."""
    jcfg, cfg = cfgs
    tree, p = block
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want, wstate = jax.jit(lambda p, x: jrec.rglru_forward(
        p, x, jcfg, return_state=True))(tree, jnp.asarray(x))
    got, gstate = rec.rglru_forward(p, torch.from_numpy(x), cfg,
                                    return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for k in ("h", "conv"):
        assert tuple(gstate[k].shape) == wstate[k].shape, k
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   atol=1e-4, rtol=1e-4)


def test_causal_conv_and_step_match_reference(cfgs, block):
    _, cfg = cfgs
    tree, p = block
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.lru_width)).astype(np.float32)
    w = {"w": jnp.asarray(tree["conv"]["w"])}
    np.testing.assert_allclose(
        rec.causal_conv(p.conv, torch.from_numpy(x)).numpy(),
        np.asarray(jrec.causal_conv(w, jnp.asarray(x))), atol=1e-5,
        rtol=1e-5)
    state = rng.standard_normal(
        (2, cfg.conv_width - 1, cfg.lru_width)).astype(np.float32)
    got, gs = rec.causal_conv_step(p.conv, torch.from_numpy(x[:, 0]),
                                   torch.from_numpy(state))
    want, ws = jrec.causal_conv_step(w, jnp.asarray(x[:, 0]),
                                     jnp.asarray(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5,
                               rtol=1e-5)


def test_rglru_decode_matches_reference(cfgs, block):
    jcfg, cfg = cfgs
    tree, p = block
    rng = np.random.default_rng(6)
    cache = {"h": rng.standard_normal((2, cfg.lru_width)).astype(np.float32),
             "conv": rng.standard_normal(
                 (2, cfg.conv_width - 1, cfg.lru_width)).astype(np.float32)}
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, wc = jrec.rglru_decode(
            tree, jnp.asarray(x), jcfg,
            {k: jnp.asarray(v) for k, v in cache.items()})
        got, gc = rec.rglru_decode(
            p, torch.from_numpy(x), cfg,
            {k: torch.tensor(v) for k, v in cache.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        for k in ("h", "conv"):
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       atol=1e-5, rtol=1e-5)
        cache = {k: np.asarray(v) for k, v in wc.items()}
