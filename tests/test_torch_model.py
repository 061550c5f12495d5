"""The port's model-serving slice against the JAX package:
``reduced(recurrentgemma-2b, num_layers=5)``, one (rglru, rglru, local)
unit plus a tail of two rglru blocks, so the unstacking of ``units`` and
the tail both run. The reference's weights are carried across with
``models.params.from_reference``; prompts come from a NumPy seed.

On the CPU both packages compute in float32 and the port takes its plain
paths. Tolerances: 1e-5 for single layers; 1e-4 across the model, whose
RG-LRU layers sum in another order (the reference's associative scan
against the port's sequential loop).
"""
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import all_configs as ref_all_configs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import rope as jrope  # noqa: E402
from repro.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import all_configs, get_config, reduced  # noqa: E402
from _torch_parity import PORT_ONLY_ARCHS, assert_config_same  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import layers, rope  # noqa: E402

ARCH = "recurrentgemma-2b"
B, P, GEN = 2, 16, 8          # P: two blocks of the reduced window (8)
TOL = 1e-4


def _close(got, want, what="", tol=TOL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=what)


@pytest.fixture(scope="module")
def slice_():
    jcfg = ref_reduced(ref_get_config(ARCH), num_layers=5)
    cfg = reduced(get_config(ARCH), num_layers=5)
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    return jcfg, cfg, tree, mp.from_reference(tree, cfg, "cpu"), prompts


def test_configs_match_reference():
    assert_config_same(get_config(ARCH), ref_get_config(ARCH))
    assert_config_same(reduced(get_config(ARCH), num_layers=5),
                       ref_reduced(ref_get_config(ARCH), num_layers=5))
    cfg = reduced(get_config(ARCH), num_layers=5)
    assert (cfg.num_units, tuple(cfg.tail_pattern)) == (1, ("rglru", "rglru"))


@pytest.mark.parametrize("name", sorted(ref_all_configs()))
def test_registry_equals_reference(name):
    """The port's registry holds the reference's ten architectures, each
    config equal field for field (the port's own fields at their
    defaults), and the port's own ``deepseek-v2-lite``."""
    assert sorted(set(all_configs()) - set(PORT_ONLY_ARCHS)) \
        == sorted(ref_all_configs())
    assert len(all_configs()) == 10 + len(PORT_ONLY_ARCHS)
    assert_config_same(get_config(name), ref_get_config(name))


def test_unknown_mixer_raises_in_both_packages():
    """A mixer kind neither package knows is refused with ValueError by
    both models."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), pattern=("mamba",))
    jcfg = dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                               pattern=("mamba",))
    with pytest.raises(ValueError, match="mamba"):
        jtf.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mamba"):
        tf.Transformer(cfg, "meta")


def test_layers_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), "rms_norm",
           1e-5)
    cfg = reduced(get_config(ARCH))
    jcfg = ref_reduced(ref_get_config(ARCH))
    tree = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(2),
                                                     jcfg))
    p = mp.load_tree(layers.MLP(cfg, "cpu"), tree)
    _close(layers.mlp(p, torch.from_numpy(x), cfg),
           jlayers.mlp(tree, jnp.asarray(x), jcfg), "mlp (tanh GELU)", 1e-5)
    # torch's default GELU is the exact form: it would not match
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - layers.gelu(torch.from_numpy(x))).abs().max()) \
        > 1e-4
    q = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, None].repeat(2, 0)
    _close(rope.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4),
           jrope.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4),
           "apply_rope", 1e-5)


def test_embedding_scale_rounds_to_the_compute_dtype():
    assert float(layers.embed_scale(2560, torch.bfloat16)) == 50.5
    assert float(layers.embed_scale(2560, torch.bfloat16)) \
        == float(jnp.asarray(np.sqrt(2560), jnp.bfloat16))


def test_weights_round_trip_byte_identical(slice_):
    _, cfg, tree, model, _ = slice_
    back = mp.to_reference(model)
    want, got = mp.flatten_tree(tree), mp.flatten_tree(back)
    assert sorted(want) == sorted(got)
    assert "tail1/mixer/a_param" in got and got["units/b2/mixer/wq"].shape[0] \
        == cfg.num_units
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def _caches_close(got, want, cfg, what):
    for u in range(cfg.num_units):
        for b, blk in want["units"].items():
            for k, leaf in blk.items():
                _close(got["units"][u][b][k], np.asarray(leaf)[u],
                       f"{what} units[{u}].{b}.{k}")
    for i in range(len(cfg.tail_pattern)):
        for k, leaf in want[f"tail{i}"].items():
            _close(got[f"tail{i}"][k], leaf, f"{what} tail{i}.{k}")


def test_prefill_and_teacher_forced_decode_match_reference(slice_):
    jcfg, cfg, tree, model, prompts = slice_
    cap = P + GEN
    want_logits, jcache = jtf.prefill(tree, jcfg, jnp.asarray(prompts),
                                      capacity=cap)
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, torch.from_numpy(prompts),
                                   capacity=cap)
    _close(logits, want_logits, "prefill logits")
    _caches_close(cache, jcache, cfg, "prefill")
    decode = jax.jit(lambda p, c, x, pos: jtf.decode_step(p, jcfg, c, x, pos))
    forced = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (GEN, B, 1)).astype(np.int32)
    for t in range(GEN):
        want_logits, jcache = decode(tree, jcache, jnp.asarray(forced[t]),
                                     P + t)
        with torch.inference_mode():
            logits, cache = tf.decode_step(model, cfg, cache,
                                           torch.from_numpy(forced[t]), P + t)
        _close(logits, want_logits, f"decode step {t} logits")
        _caches_close(cache, jcache, cfg, f"decode step {t}")


def test_forward_matches_reference(slice_):
    jcfg, cfg, tree, model, prompts = slice_
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(P, dtype=np.int32),
                                               (B, P)))
    want, want_aux = jtf.forward(tree, jcfg, jnp.asarray(prompts),
                                 jnp.asarray(pos))
    with torch.inference_mode():
        got, aux = tf.forward(model, cfg, torch.from_numpy(prompts),
                              torch.from_numpy(pos))
    _close(got, want, "forward hidden")
    assert float(aux) == float(want_aux) == 0.0


def test_prefill_step_matches_reference(slice_):
    jcfg, cfg, tree, model, prompts = slice_
    want_logits, jcache = jsteps.make_prefill_step(jcfg)(
        tree, {"inputs": jnp.asarray(prompts)})
    with torch.inference_mode():
        logits, cache = steps.make_prefill_step(cfg)(
            model, {"inputs": torch.from_numpy(prompts)})
    _close(logits, want_logits, "prefill step logits")
    _caches_close(cache, jcache, cfg, "prefill step")


def test_generate_greedy_matches_reference(slice_):
    jcfg, cfg, tree, model, prompts = slice_
    want = jserve.Server(jcfg, tree).generate(prompts, GEN)
    got = serve.Server(cfg, model).generate(prompts, GEN)
    assert got.dtype == np.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded():
    cfg = reduced(get_config(ARCH), num_layers=5)
    gen = torch.Generator().manual_seed(0)
    server = serve.Server(cfg, tf.init_params(cfg, gen, "cpu"))
    prompts = np.zeros((2, 8), np.int32)
    a = server.generate(prompts, 4, greedy=False, seed=7)
    b = server.generate(prompts, 4, greedy=False, seed=7)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_checkpoint_across_packages(slice_, tmp_path):
    """The reference saves a train state (params plus the optimizer leaves
    ``_opt_like`` makes); the port's Server.from_checkpoint restores it and
    generates the reference's greedy tokens."""
    jcfg, cfg, tree, _, prompts = slice_
    CheckpointManager(tmp_path).save(
        {"params": tree, **jserve._opt_like(tree)}, epoch=0, step=3)
    want = jserve.Server.from_checkpoint(jcfg, tmp_path).generate(prompts,
                                                                  GEN)
    server = serve.Server.from_checkpoint(cfg, tmp_path, device="cpu")
    np.testing.assert_array_equal(server.generate(prompts, GEN), want)
    back = mp.flatten_tree(mp.to_reference(server.params))
    for k, leaf in mp.flatten_tree(tree).items():
        assert back[k].tobytes() == leaf.tobytes(), k


def test_chip_smoke_layer_check_catches_planted_faults(monkeypatch):
    """chip_smoke.py's layer-by-layer check, rehearsed on the CPU with the
    plain versions standing in for the CUDA kernels on the kernel route:
    no layer differs, and the faults it plants in that route (the causal
    mask off, the window dropped, the scan's b one step late) exceed its
    limits."""
    from repro_torch.kernels import ops, ref

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda q, k, v, *, causal, window: ref.flash_attention(
                            q, k, v, causal=causal, window=window))
    monkeypatch.setattr(ops._lru, "lru_scan", ref.lru_scan)
    cfg = reduced(get_config(ARCH), num_layers=5)
    run = cs.serve_model(torch, cfg, "cpu", requests=2, prompt=P, gen=2)
    got = cs.check_layers_against_plain(torch, run)
    assert len(got["per_layer"]) == cfg.num_layers
    assert max(got["worst"].values()) == 0.0
    assert sorted(got["planted"]) == ["layer0 b one step late",
                                      "layer2 causal off",
                                      "layer2 window dropped"]
    for errs in got["planted"].values():
        assert errs["out"] > cs.MIXER_RTOL
