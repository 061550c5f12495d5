"""The port's xLSTM family against the JAX package: the mLSTM and sLSTM
mixers of ``nn/recurrent.py`` and ``xlstm-1.3b`` on its reduced config
(one mLSTM and one sLSTM block, d_model 64, 4 heads: mLSTM hd 32, sLSTM
hd 16), through the cells, every mLSTM route, decode, the whole model's
forward, prefill, decode and greedy tokens, the training loss's gradients
and the launch commands.

Weights come from the reference's initialisers and cross with
``models.params.from_reference`` / ``load_tree``. At that init the
matrix memory is about 3e-5 and the sLSTM's gates alike, so every
recurrent weight is scaled by ``GAIN`` and every constant (norm scales and
biases, ``b_if``, ``head_norm``) gets N(0, 0.1^2) noise; the sLSTM's
four gates get distinct weights (``_distinct_gates``), so that a gate
swap cannot pass. Inputs come from a NumPy seed.

On the CPU both packages compute in float32 and the port takes its plain
paths. Tolerances, each relative to the tensor's largest magnitude: the
reference's own for these mixers (``tests/test_perf_variants.py``: atol
1e-5 and rtol 1e-4 on outputs, states rtol 1e-3); across the model 1e-4;
the loss and every gradient within 1e-4 of the largest. The port takes
log sigmoid(f) as ``F.logsigmoid`` where the reference writes
-softplus(-f); they agree to float32 rounding.
"""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.nn import recurrent as jrec  # noqa: E402
from _torch_parity import load_chip_smoke  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import recurrent as rec  # noqa: E402
from repro_torch.train.data import TokenPipeline  # noqa: E402

ARCH = "xlstm-1.3b"
B, S, CHUNK, STEPS = 2, 64, 16, 4
ATOL, RTOL, STATE_RTOL = 1e-5, 1e-4, 1e-3
MODEL_TOL, GRAD_TOL = 1e-4, 1e-4
# the mLSTM's three routes: (mlstm_impl, mlstm_chunk)
ROUTES = {"scan": ("scan", 0), "scan chunked": ("scan", CHUNK),
          "chunkwise": ("chunkwise", CHUNK)}
# recurrent weights scaled so that the states are of order 1e-2 to 1
GAIN = {"wq": 8.0, "wk": 8.0, "wv": 8.0, "w_if": 8.0, "up": 4.0,
        "w_gates": 4.0, "r_gates": 8.0}
NOISY = ("scale", "bias", "b_if", "head_norm", "b_gates")


def _close(got, want, what="", atol=ATOL, rtol=RTOL):
    """|got - want| <= (atol + rtol |want / max|want||) max|want|."""
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    top = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g / top, w / top, atol=atol, rtol=rtol,
                               err_msg=what)


def _cfgs(route="scan", **kw):
    impl, chunk = ROUTES[route]
    kw = {"mlstm_impl": impl, "mlstm_chunk": chunk, **kw}
    return (ref_reduced(ref_get_config(ARCH), **kw),
            reduced(get_config(ARCH), **kw))


def _strengthen(flat, seed):
    """Scale the recurrent weights by GAIN, add noise to the constants and
    give the sLSTM's gates distinct weights, in a flat tree, in place."""
    rng = np.random.default_rng(seed + 100)
    for path in sorted(flat):
        leaf = path.rsplit("/", 1)[-1]
        if leaf in GAIN:
            flat[path] = (flat[path] * GAIN[leaf]).astype(np.float32)
        if leaf in NOISY:
            flat[path] = (flat[path] + 0.1 * rng.standard_normal(
                flat[path].shape)).astype(np.float32)
    for path in sorted(flat):
        if path.endswith("r_gates") or path.endswith("b_gates"):
            flat[path] = _distinct_gates(flat[path], path.endswith("b_gates"))
    return flat


# per gate z, i, f, o: a scale of its weights and an offset of its bias
GATE_SCALE, GATE_OFFSET = (1.0, 0.5, 1.5, 0.75), (0.0, -0.5, 2.0, 0.5)


def _distinct_gates(a, bias):
    """r_gates (..., hd, 4 hd), z, i, f, o within each head, or b_gates
    (..., 4 d), gate-major: each gate's block scaled or offset apart."""
    out = np.array(a, dtype=np.float32)
    blocks = np.split(out, 4, axis=-1)
    for g, blk in enumerate(blocks):
        if bias:
            blk += GATE_OFFSET[g]
        else:
            blk *= GATE_SCALE[g]
    return np.concatenate(blocks, axis=-1).astype(np.float32)


def _layer(kind, seed=0, route="scan"):
    """One reference mixer's strengthened weights, the port's module
    holding them, both configs and (B, S, D) inputs."""
    jcfg, cfg = _cfgs(route)
    init = jrec.init_mlstm_block if kind == "mlstm" else jrec.init_slstm_block
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    tree = mp.unflatten_tree(_strengthen(mp.flatten_tree(tree), seed))
    module = rec.MLSTM if kind == "mlstm" else rec.SLSTM
    p = mp.load_tree(module(cfg, "cpu"), tree)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, tree, p, x


def _model_tree(jcfg, seed=0):
    flat = mp.flatten_tree(jax.tree.map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(seed))))
    return mp.unflatten_tree(_strengthen(flat, seed))


@pytest.fixture(scope="module")
def models():
    """Per route: both configs, the strengthened reference tree and the
    port's model holding it (built lazily, once; one tree for all)."""
    cache = {}

    def get(route="scan"):
        if route not in cache:
            jcfg, cfg = _cfgs(route)
            tree = cache.get("tree") or _model_tree(jcfg)
            cache["tree"] = tree
            cache[route] = (jcfg, cfg, tree,
                            mp.from_reference(tree, cfg, "cpu"))
        return cache[route]
    return get


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _positions(n):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(n, dtype=np.int32), (B, n)))


def _states_close(got, want, what):
    for k, w in want.items():
        _close(got[k], w, f"{what} {k}", rtol=STATE_RTOL)


def _caches_close(got, want, cfg, what, tol=MODEL_TOL):
    for b, blk in want["units"].items():
        for k, leaf in blk.items():
            _close(got["units"][0][b][k], np.asarray(leaf)[0],
                   f"{what} {b}.{k}", atol=tol, rtol=tol)


# ------------------------------------------------------------ config, tree
def test_reduced_config_and_tree_round_trip(models):
    """Reduced xlstm: one mLSTM and one sLSTM block, no feed-forward, layer
    norms; the tree crosses both ways byte-identical, units stacked."""
    jcfg, cfg, tree, model = models()
    assert tuple(cfg.pattern) == ("mlstm", "slstm") and cfg.ffn == "none"
    assert (cfg.num_units, cfg.norm, cfg.pos_emb) == (1, "ln", "none")
    want = mp.flatten_tree(tree)
    got = mp.flatten_tree(mp.to_reference(model))
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert sorted(mp.flatten_tree(mp.reference_shapes(cfg))) == sorted(want)
    dp = int(cfg.mlstm_proj_factor * cfg.d_model)
    assert want["units/b0/mixer/wq"].shape == (1, 4, dp // 4, dp // 4)
    assert want["units/b1/mixer/r_gates"].shape == (1, 4, 16, 64)
    assert not any(k.startswith("units/b0/ffn") or k.startswith(
        "units/b1/norm2") for k in want)


def test_fresh_model_init_matches_the_reference_constants():
    """init_params draws the random weights and sets the constants as the
    reference does: b_if is 0 for the input gates and 3 for the forget
    gates, b_gates and head_norm 0, layer norms 1 and 0."""
    jcfg, cfg = _cfgs()
    want = mp.flatten_tree(jax.tree.map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    g = torch.Generator()
    g.manual_seed(0)
    got = mp.flatten_tree(mp.to_reference(tf.init_params(cfg, g, "cpu")))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.rsplit("/", 1)[-1] in ("b_if", "b_gates", "head_norm", "scale",
                                    "bias"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert 0.015 < float(got[k].std()) < 0.025, k


def test_weight_dtypes_when_serving_on_a_card(monkeypatch):
    """A serving model on a card holds in bf16 only the weights that reach
    dense (up, down, up1, up2); what the reference reads in float32 stays
    float32."""
    monkeypatch.setattr(rec, "weight_dtype",
                        lambda cfg, device, trainable=False: torch.bfloat16)
    _, cfg = _cfgs()
    m, s = rec.MLSTM(cfg, "meta"), rec.SLSTM(cfg, "meta")
    bf16 = {n for mod, names in ((m, ("up", "down")),
                                 (s, ("up1", "up2", "down")))
            for n in names if getattr(mod, n).dtype == torch.bfloat16}
    assert bf16 == {"up", "down", "up1", "up2"}
    for mod, names in ((m, ("wq", "wk", "wv", "w_if", "b_if", "head_norm")),
                       (s, ("w_gates", "r_gates", "b_gates", "head_norm"))):
        assert {getattr(mod, n).dtype for n in names} == {torch.float32}
    assert m.conv.w.dtype == torch.float32


# --------------------------------------------------------------------- mLSTM
def _qkvif(kind_route="scan"):
    jcfg, cfg, tree, p, x = _layer("mlstm", route=kind_route)
    xm = x @ tree["up"][:, :tree["w_if"].shape[0]]
    want = jrec._mlstm_qkvif(tree, jnp.asarray(xm), jcfg)
    with torch.inference_mode():
        got = rec._mlstm_qkvif(p, torch.from_numpy(xm), cfg)
    return want, got


def test_mlstm_qkvif_matches_reference():
    want, got = _qkvif()
    for name, g, w in zip(("q", "k", "v", "i_pre", "f_pre"), got, want):
        _close(g, w, f"_mlstm_qkvif {name}")


def test_mlstm_cell_step_matches_reference():
    """Eight steps of the cell from a nonzero carry, m included."""
    want, got = _qkvif()
    rng = np.random.default_rng(5)
    H, hd = want[0].shape[2:]
    carry = (rng.standard_normal((B, H, hd, hd)).astype(np.float32),
             rng.standard_normal((B, H, hd)).astype(np.float32),
             rng.standard_normal((B, H)).astype(np.float32))
    jc, pc = tuple(map(jnp.asarray, carry)), tuple(map(torch.from_numpy,
                                                      carry))
    for t in range(8):
        jc, jh = jrec._mlstm_cell_step(jc, tuple(a[:, t] for a in want))
        with torch.inference_mode():
            pc, ph = rec._mlstm_cell_step(pc, tuple(a[:, t] for a in got))
        _close(ph, jh, f"cell step {t} h")
        for name, g, w in zip("Cnm", pc, jc):
            _close(g, w, f"cell step {t} {name}", rtol=STATE_RTOL)


def test_mlstm_chunkwise_matches_reference():
    want, got = _qkvif()
    jh, jcarry = jrec._mlstm_chunkwise(*want, CHUNK)
    with torch.inference_mode():
        h, carry = rec._mlstm_chunkwise(*got, CHUNK)
    _close(h, jh, "_mlstm_chunkwise h")
    for name, g, w in zip("Cnm", carry, jcarry):
        _close(g, w, f"_mlstm_chunkwise {name}", rtol=STATE_RTOL)
    assert float(np.abs(np.asarray(jcarry[0])).max()) > 1e-2


@pytest.mark.parametrize("route", ROUTES)
def test_mlstm_forward_matches_reference(route):
    """All three routes, chosen by the reference's conditions, with the
    decode state at the end (C, n, m and the conv state)."""
    jcfg, cfg, tree, p, x = _layer("mlstm", route=route)
    jy, jst = jrec.mlstm_forward(tree, jnp.asarray(x), jcfg,
                                 return_state=True)
    with torch.inference_mode():
        y, st = rec.mlstm_forward(p, torch.from_numpy(x), cfg,
                                  return_state=True)
    _close(y, jy, f"mlstm_forward {route}")
    _states_close(st, jst, f"mlstm_forward {route}")


def test_mlstm_routes_agree_as_the_reference_checks():
    """tests/test_perf_variants.py's check on the port: the chunkwise
    route equals the sequential one."""
    _, cfg, _, p, x = _layer("mlstm")
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        y0, s0 = rec.mlstm_forward(p, xt, cfg, return_state=True)
        y1, s1 = rec.mlstm_forward(p, xt, _cfgs("chunkwise")[1],
                                   return_state=True)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), atol=1e-5, rtol=1e-4)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(s0[k].numpy(), s1[k].numpy(), atol=1e-5,
                                   rtol=1e-3)


def test_mlstm_decode_matches_reference():
    """Four decode steps from a prefill's state."""
    jcfg, cfg, tree, p, x = _layer("mlstm")
    _, jst = jrec.mlstm_forward(tree, jnp.asarray(x[:, :S - STEPS]), jcfg,
                                return_state=True)
    with torch.inference_mode():
        _, st = rec.mlstm_forward(p, torch.from_numpy(x[:, :S - STEPS]), cfg,
                                  return_state=True)
        for t in range(S - STEPS, S):
            xt = x[:, t:t + 1]
            jy, jst = jrec.mlstm_decode(tree, jnp.asarray(xt), jcfg, jst)
            y, st = rec.mlstm_decode(p, torch.from_numpy(xt), cfg, st)
            _close(y, jy, f"mlstm_decode {t}")
            _states_close(st, jst, f"mlstm_decode {t}")


# --------------------------------------------------------------------- sLSTM
def _wx(tree, x, jcfg):
    """(S, B, H, 4 hd) gate pre-activations, as slstm_forward builds them."""
    H = jcfg.n_heads
    wx = x @ tree["w_gates"] + tree["b_gates"]
    return np.ascontiguousarray(wx.reshape(B, S, 4, H, -1).transpose(
        1, 0, 3, 2, 4).reshape(S, B, H, -1)).astype(np.float32)


def _slstm_carry(wx):
    """A nonzero sLSTM carry (c, n > 0, m, h) for the gate pre-activations
    ``wx`` (S, B, H, 4 hd)."""
    rng = np.random.default_rng(6)
    shape = wx.shape[1:3] + (wx.shape[-1] // 4,)
    carry = tuple(rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    return (carry[0], np.abs(carry[1]) + 0.5, carry[2], carry[3])


def test_slstm_step_matches_reference():
    """Eight steps of the cell with distinct weights per gate, from a
    nonzero carry."""
    jcfg, cfg, tree, p, x = _layer("slstm")
    wx = _wx(tree, x, jcfg)
    carry = _slstm_carry(wx)
    jc, pc = tuple(map(jnp.asarray, carry)), tuple(map(torch.from_numpy,
                                                      carry))
    r = torch.from_numpy(tree["r_gates"])
    for t, w in enumerate(wx[:8]):
        jc, jh = jrec._slstm_step(jnp.asarray(tree["r_gates"]), jc,
                                  jnp.asarray(w))
        with torch.inference_mode():
            pc, ph = rec._slstm_step(r, pc, torch.from_numpy(w))
        _close(ph, jh, f"slstm step {t} h")
        for name, g, v in zip("cnmh", pc, jc):
            _close(g, v, f"slstm step {t} {name}", rtol=STATE_RTOL)


def test_slstm_gate_swap_fails_parity(monkeypatch):
    """A planted i/f gate swap in the port's cell fails the forward parity
    with the reference (the gates' weights are distinct)."""
    jcfg, cfg, tree, p, x = _layer("slstm")
    jy = np.asarray(jrec.slstm_forward(tree, jnp.asarray(x), jcfg))
    monkeypatch.setattr(rec, "_slstm_step",
                        load_chip_smoke().swap_i_f(torch, rec._slstm_step))
    with torch.inference_mode():
        y = rec.slstm_forward(p, torch.from_numpy(x), cfg)
    with pytest.raises(AssertionError):
        _close(y, jy, "slstm_forward with i and f swapped")


@pytest.mark.parametrize("chunk", (0, CHUNK))
def test_slstm_forward_matches_reference(chunk):
    """The plain scan and the scan chunked by mlstm_chunk (the reference's
    checkpoint per chunk), with the final (c, n, m, h)."""
    jcfg, cfg, tree, p, x = _layer("slstm")
    jcfg = dataclasses.replace(jcfg, mlstm_chunk=chunk)
    cfg = dataclasses.replace(cfg, mlstm_chunk=chunk)
    jy, jst = jrec.slstm_forward(tree, jnp.asarray(x), jcfg,
                                 return_state=True)
    with torch.inference_mode():
        y, st = rec.slstm_forward(p, torch.from_numpy(x), cfg,
                                  return_state=True)
    _close(y, jy, f"slstm_forward chunk {chunk}")
    _states_close(st, jst, f"slstm_forward chunk {chunk}")
    assert float(np.abs(np.asarray(jst["c"])).max()) > 1e-1


def test_slstm_decode_matches_reference():
    jcfg, cfg, tree, p, x = _layer("slstm")
    _, jst = jrec.slstm_forward(tree, jnp.asarray(x[:, :S - STEPS]), jcfg,
                                return_state=True)
    with torch.inference_mode():
        _, st = rec.slstm_forward(p, torch.from_numpy(x[:, :S - STEPS]), cfg,
                                  return_state=True)
        for t in range(S - STEPS, S):
            xt = x[:, t:t + 1]
            jy, jst = jrec.slstm_decode(tree, jnp.asarray(xt), jcfg, jst)
            y, st = rec.slstm_decode(p, torch.from_numpy(xt), cfg, st)
            _close(y, jy, f"slstm_decode {t}")
            _states_close(st, jst, f"slstm_decode {t}")


@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_chunked_checkpoint_keeps_the_gradients(kind):
    """Under grad, the chunked routes run each chunk under
    torch.utils.checkpoint; the input's gradient equals the plain scan's."""
    _, cfg, _, p, x = _layer(kind)
    fwd = rec.mlstm_forward if kind == "mlstm" else rec.slstm_forward
    grads = []
    for route in ("scan", "scan chunked", "chunkwise"):
        xt = torch.from_numpy(x).requires_grad_(True)
        fwd(p, xt, _cfgs(route)[1]).square().sum().backward()
        grads.append(xt.grad.numpy())
    for g in grads[1:]:
        _close(g, grads[0], f"{kind} input gradient", rtol=1e-3)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("route", ROUTES)
def test_forward_matches_reference(models, route):
    jcfg, cfg, tree, model = models(route)
    x, pos = _tokens(cfg, (B, S), 2), _positions(S)
    want, _ = jtf.forward(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got, aux = tf.forward(model, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, f"{route} forward hidden", MODEL_TOL, MODEL_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("route", ("scan", "chunkwise"))
def test_prefill_and_decode_match_reference(models, route):
    """Prefill (last-position logits and both blocks' caches), then STEPS
    decode steps fed the reference's greedy token."""
    jcfg, cfg, tree, model = models(route)
    x = _tokens(cfg, (B, S), 3)
    want_logits, jcache = jtf.prefill(tree, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, torch.from_numpy(x))
    _close(logits, want_logits, f"{route} prefill logits", MODEL_TOL,
           MODEL_TOL)
    _caches_close(cache, jcache, cfg, f"{route} prefill")
    decode = jax.jit(lambda p, c, x, pos: jtf.decode_step(p, jcfg, c, x, pos))
    for t in range(STEPS):
        nxt = np.array(jnp.argmax(want_logits[:, -1], axis=-1),
                       np.int32)[:, None]
        want_logits, jcache = decode(tree, jcache, jnp.asarray(nxt), S + t)
        with torch.inference_mode():
            logits, cache = tf.decode_step(model, cfg, cache,
                                           torch.from_numpy(nxt), S + t)
        _close(logits, want_logits, f"{route} decode step {t} logits",
               MODEL_TOL, MODEL_TOL)
        _caches_close(cache, jcache, cfg, f"{route} decode step {t}")


def test_generate_greedy_matches_reference(models):
    jcfg, cfg, tree, model = models()
    prompts = _tokens(cfg, (B, S), 5)
    want = jserve.Server(jcfg, tree).generate(prompts, STEPS)
    got = serve.Server(cfg, model).generate(prompts, STEPS)
    assert got.dtype == np.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got, want)


def test_reference_decode_convolves_with_the_kernel_reversed():
    """The reference's prefill convolution (causal_conv) weights x[t - k]
    by w[k]; its decode step (causal_conv_step) weights x[t - k] by
    w[W - 1 - k]. The port matches both (ROADMAP, reference quirks)."""
    jcfg, cfg, tree, p, x = _layer("mlstm")
    xm = x[:, :8, :1].repeat(4, axis=2) * np.arange(1, 5, dtype=np.float32)
    w = np.array(tree["conv"]["w"][:, :4])
    conv = rec.Conv(4, 4, torch.float32, "cpu")
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w))
    state = torch.from_numpy(np.ascontiguousarray(xm[:, 4:7]))
    with torch.inference_mode():
        step, _ = rec.causal_conv_step(conv, torch.from_numpy(xm[:, 7]),
                                       state)
        full = rec.causal_conv(conv, torch.from_numpy(xm))[:, 7]
        conv.w.copy_(conv.w.flip(0))
        flipped = rec.causal_conv(conv, torch.from_numpy(xm))[:, 7]
    jstep, _ = jrec.causal_conv_step({"w": jnp.asarray(w)},
                                     jnp.asarray(xm[:, 7]),
                                     jnp.asarray(xm[:, 4:7]))
    _close(step, jstep, "causal_conv_step")
    _close(step, flipped, "decode step = prefill with the kernel reversed")
    assert float((step - full).abs().max()) > 1e-2


@pytest.mark.parametrize("route", ("scan", "chunkwise"))
def test_prefill_then_decode_continues_the_prefill(models, route):
    """Prefill P and decode n continue as a prefill of P + n once the
    convolution kernels are palindromes (the reference reverses the kernel
    in decode); on the CPU (float32 throughout) nothing is rounded to bf16,
    so the conv dtype quirk has no part. With the random kernels the
    reversal shows."""
    _, cfg, _, model = models(route)
    x = _tokens(cfg, (B, S), 6)
    P = S - CHUNK

    def gap():
        with torch.inference_mode():
            _, cache = tf.prefill(model, cfg, torch.from_numpy(x[:, :P]))
            for t in range(P, S):
                logits, cache = tf.decode_step(
                    model, cfg, cache, torch.from_numpy(x[:, t:t + 1]), t)
            want_logits, want = tf.prefill(model, cfg, torch.from_numpy(x))
        return logits, cache, want_logits, want

    with load_chip_smoke().palindromic_convs(torch, model):
        logits, cache, want_logits, want = gap()
    _close(logits, want_logits, "continued logits", MODEL_TOL, MODEL_TOL)
    for b in ("b0", "b1"):
        for k, w in want["units"][0][b].items():
            _close(cache["units"][0][b][k], w, f"continued {b}.{k}",
                   MODEL_TOL, MODEL_TOL)
    logits, _, want_logits, _ = gap()
    assert float((logits - want_logits).abs().max()) \
        > 1e-2 * float(want_logits.abs().max())


@pytest.mark.parametrize("prompt", (1, 2))
def test_short_prompt_decode_raises_as_the_reference(models, prompt):
    """A prompt shorter than conv_width - 1 leaves a short conv state, on
    which the reference's decode raises ValueError; the port's does too
    (ROADMAP, reference quirks)."""
    jcfg, cfg, tree, model = models()
    x = _tokens(cfg, (B, prompt), 7)
    nxt = np.zeros((B, 1), np.int32)
    _, jcache = jtf.prefill(tree, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError):
        jtf.decode_step(tree, jcfg, jcache, jnp.asarray(nxt), prompt)
    with torch.inference_mode():
        _, cache = tf.prefill(model, cfg, torch.from_numpy(x))
        assert cache["units"][0]["b0"]["conv"].shape[1] == 1
        with pytest.raises(ValueError, match="conv state"):
            tf.decode_step(model, cfg, cache, torch.from_numpy(nxt), prompt)


@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_gradients_match_jax_grad(models, route):
    """steps.loss_fn and every parameter's gradient against jax.grad of
    the reference's loss_fn, within 1e-4 of the largest, on each mLSTM
    route (the chunked ones through torch.utils.checkpoint inside the
    unit's remat)."""
    jcfg, cfg, tree, _ = models(route)
    jcfg = dataclasses.replace(jcfg, mlstm_chunk=ROUTES[route][1] // 2)
    cfg = dataclasses.replace(cfg, mlstm_chunk=ROUTES[route][1] // 2)
    batch = TokenPipeline(cfg.vocab_size, B, 16, seed=1).batch_view(0).value()
    (jl, _), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, batch)
    model = mp.from_reference(tree, cfg, "cpu", trainable=True)
    loss, _ = steps.loss_fn(model, cfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=GRAD_TOL)
    grads = mp.flatten_tree(mp.named_to_reference(
        {n: p.grad for n, p in model.named_parameters()}))
    want = mp.flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, atol=GRAD_TOL * top, rtol=0,
                                   err_msg=k)
    for k in ("units/b0/mixer/wq", "units/b1/mixer/r_gates"):
        assert float(np.abs(grads[k]).max()) > 0


# ------------------------------------------------------------------- launch
def test_train_sizes_the_full_model_to_fit():
    """xlstm-1.3b: 2,019,559,424 parameters by the reference's analytic
    count (the model holds 51,392 more: layer-norm biases, b_if and the
    mLSTM's head_norm, which it leaves out), 32.3 GB of float32 training
    state, under 75 % of an 80 GiB card: check_fits passes it."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == 2_019_559_424
    model = tf.Transformer(cfg, "meta")
    assert sum(p.numel() for p in model.parameters()) == 2_019_610_816
    need = ptrain.STATE_BYTES_PER_PARAM * cfg.param_count()
    assert 32.3e9 < need < 32.4e9 < 0.75 * 80 * 2**30


def test_launch_commands_accept_xlstm(monkeypatch, tmp_path):
    """``--arch xlstm-1.3b``: serve answers on the reduced config and train
    runs 30 steps (its loss must fall), on the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device",
                                      "cpu", "--requests", "2",
                                      "--prompt-len", "16", "--gen", "2"])
    serve.main()
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--device", "cpu", "--steps", "30",
        "--batch", "4", "--seq", "32", "--ckpt-every", "100",
        "--ckpt-dir", str(tmp_path)])
    ptrain.main()


# ------------------------------------------------ chip_smoke.py phase 11
def test_chip_smoke_xlstm_serving_checks_rehearse_on_cpu():
    """Phase 11's serving checks on the CPU at the reduced size: the run
    launches no kernel; the decode bound counts each recurrent layer's
    state read and written; the chunkwise route agrees with the scan
    route layer by layer and as a whole (the same float32 recurrence: to
    1e-6 here), the carry without decay_in over the limits; continuity
    holds layer by layer and as a whole with palindromic kernels, and the
    unshifted conv state and the random kernels' reversal exceed it. On
    the CPU nothing is rounded to bf16, so removing the conv rounding
    changes nothing. The kernels are restored after."""
    cs = load_chip_smoke()
    _, cfg = _cfgs()
    run = cs.serve_model(torch, cfg, "cpu", requests=B, prompt=S, gen=3)
    assert not any(run["counts"].values())
    bound = cs.decode_bound(run["model"], cfg, B, S, 3)
    dp = int(cfg.mlstm_proj_factor * cfg.d_model)
    state = 4 * B * (dp * dp // 4 + dp + 4 + 3 * dp + 4 * cfg.d_model)
    assert bound["state_bytes"] == 2 * state and bound["cache_bytes"] == 0
    convs = [p.clone() for n, p in run["model"].named_parameters()
             if n.endswith("conv.w")]
    routes = cs.check_xlstm_routes(torch, run, chunk=CHUNK)
    assert routes["whole"]["err"] <= 1e-6
    assert max(routes["layer_worst"].values()) <= 1e-6
    assert set(routes["layer_worst"]) == {
        "out", "state.C", "state.n", "state.m", "state.conv", "state.c",
        "state.h"}
    assert cs.over_limits(routes["planted"]["carry without decay_in"],
                          cs.XLSTM_STATE_RTOL)
    logits, cache = routes["scan"]
    assert logits.shape == (B, 1, cfg.vocab_size) and len(cache["units"]) == 1
    cont = cs.check_xlstm_continuity(torch, run, prompt=S - 8, steps=8)
    assert cont["whole"]["err"] <= 1e-5
    assert max(cont["layer_worst"].values()) <= 1e-5
    assert max(cont["unrounded_worst"].values()) <= 1e-5
    for name in ("conv state unshifted", "reversed kernels"):
        assert cs.over_limits(cont[name], cs.XLSTM_CONT_RTOL), name
    assert all(torch.equal(a, p) for a, (n, p) in zip(convs, (
        (n, p) for n, p in run["model"].named_parameters()
        if n.endswith("conv.w"))))
    assert not torch.equal(convs[0], convs[0].flip(0))
    assert rec.mlstm_forward.__name__ == "mlstm_forward"


def test_chip_smoke_xlstm_mixer_checks_rehearse_on_cpu():
    """Phase 11's one-layer checks against float64 on the CPU: every case
    within its limits, every planted fault over one, but the unrounded
    prefill conv, which on the CPU (float32 compute) has nothing to round
    and is the one fault missed here."""
    cs = load_chip_smoke()
    _, cfg = _cfgs()
    m = cs.check_xlstm_mixers(torch, cfg, "cpu", batch=1, seq=S,
                              chunk=CHUNK)
    assert set(m["cases"]) == {"mLSTM scan", "mLSTM chunkwise", "sLSTM"}
    for e in m["cases"].values():
        assert e["out"] <= 1e-5 and max(
            v for k, v in e.items() if k != "out") <= cs.XLSTM_STATE_RTOL
    assert m["cases"]["sLSTM"]["gelu"] <= cs.XLSTM_GELU_RTOL
    assert m["missed"] == ["mLSTM scan: prefill conv unrounded"]
    planted = m["planted"]
    assert planted["mLSTM scan: m held at 0"]["state.m"] == 1.0
    assert planted["sLSTM: exact F.gelu"]["gelu"] > 10 * cs.XLSTM_GELU_RTOL
    for name in ("mLSTM chunkwise: carry without decay_in",
                 "sLSTM: i and f swapped"):
        assert planted[name]["out"] > cs.MIXER_RTOL
    # every swap was undone
    assert rec.gelu.__name__ == "gelu" and rec._gates.__name__ == "_gates"
    assert rec._mlstm_chunk.__name__ == "_mlstm_chunk"


def test_chip_smoke_xlstm_training_rehearses_on_cpu():
    """Phase 11's training on the CPU: launch.train.run on the chunkwise
    route, 1 + 2 steps, no kernel launched (the family has none), the
    first loss within 1 of ln(vocab)."""
    cs = load_chip_smoke()
    _, cfg = _cfgs("chunkwise", mlstm_chunk=8)
    run = cs.train_model(torch, cfg, "cpu", batch=2, seq=16, warmup=1,
                         steps=2)
    assert len(run["losses"]) == 3 and not any(run["counts"].values())
    assert cs.launches_per_step(cfg) == {
        "lru_scan": 0, "lru_scan_bwd": 0, "flash_attention": 0,
        "flash_attention_bwd": 0}


def test_chip_smoke_phase11_sizes():
    """Phase 11's configurations: the served model is the full one on the
    config's own route; the routes' chunk divides every prompt; the
    training cut keeps 2 layers of each kind; the limits are ordered."""
    cs = load_chip_smoke()
    cfg = cs.xlstm_config()
    assert cfg == get_config(ARCH) and cfg.num_layers == 48
    assert (cfg.mlstm_impl, cfg.mlstm_chunk) == ("scan", 0)
    train = cs.xlstm_config("chunkwise", cs.XLSTM_CHUNK,
                            cs.XLSTM_TRAIN_LAYERS)
    assert [k for _, k in tf.Transformer(train, "meta").blocks()] \
        == ["mlstm", "slstm"] * 2
    for S_ in (cs.XLSTM_PROMPT, cs.XLSTM_LONG[1], cs.XLSTM_TRAIN_SEQ,
               cs.XLSTM_LAYER[1]):
        assert S_ % cs.XLSTM_CHUNK == 0 and S_ > cs.XLSTM_CHUNK
    assert cs.XLSTM_CONT_PROMPT + cs.XLSTM_GEN <= cs.XLSTM_PROMPT
    long = cs.xlstm_config("chunkwise", cs.XLSTM_CHUNK, cs.XLSTM_LONG_LAYERS)
    assert [k for _, k in tf.Transformer(long, "meta").blocks()] \
        == ["mlstm", "slstm"] * 2
    assert cs.XLSTM_GELU_RTOL < cs.XLSTM_STATE_RTOL < cs.MIXER_RTOL \
        <= cs.XLSTM_CONT_RTOL < cs.XLSTM_ROUTE_RTOL
