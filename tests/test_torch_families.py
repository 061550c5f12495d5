"""The port's dense-attention and frames families against the JAX package:
``qwen1.5-110b``, ``starcoder2-7b`` and ``gemma3-27b`` (token input) and
``internvl2-76b`` and ``musicgen-medium`` (frames input, no embedding
table), each on its reduced config. gemma3 runs 8 layers: one unit of its
5 local + 1 global pattern and a tail of 2 local blocks, with a prompt of
16, two of its reduced window (8). musicgen keeps ``n_kv_heads=n_heads``:
``reduced()`` alone would make it GQA 4/2.

The reference initialises every norm scale at zero (RMS) or one (LN) and
every bias at zero; with those weights a post-block norm is the identity
and a bias adds nothing, so no test could tell ``post1`` from ``post2``.
Each test therefore adds seeded noise to every norm scale and bias of the
reference's tree before carrying it across with
``models.params.from_reference``. Inputs (tokens, frames) come from a NumPy
seed.

On the CPU both packages compute in float32 and the port takes its plain
paths. Tolerances: 1e-5 for one layer; 1e-4 across the model (blocked
attention and the float32 sums in another order); the loss and every
gradient of the frames training loss within 1e-4 of the largest.
"""
import dataclasses

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
from repro.nn import layers as jlayers  # noqa: E402
from _torch_parity import assert_config_same, load_chip_smoke  # noqa: E402,E501
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.train.data import TokenPipeline  # noqa: E402

TOKENS = ("qwen1.5-110b", "starcoder2-7b", "gemma3-27b")
FRAMES = ("internvl2-76b", "musicgen-medium")
ARCHS = TOKENS + FRAMES
# per arch, the overrides of reduced(): gemma3 one unit and a tail of two,
# musicgen kept multi-head (reduced() alone gives it 2 kv heads)
OVERRIDES = {"gemma3-27b": {"num_layers": 8},
             "musicgen-medium": {"n_kv_heads": 4}}
B, P, STEPS = 2, 16, 4
LAYER_TOL, MODEL_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
# leaves the reference initialises to constants: norm scales and biases
NOISY = ("scale", "bias", "b1", "b2", "bq", "bk", "bv", "q_norm", "k_norm")


def _close(got, want, what="", tol=MODEL_TOL):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=what)


def _cfgs(arch, **kw):
    kw = {**OVERRIDES.get(arch, {}), **kw}
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _noisy_tree(jcfg, seed=0):
    """The reference's initial weights with N(0, 0.1^2) noise added to
    every norm scale and bias."""
    flat = mp.flatten_tree(jax.tree.map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 100)
    for path in sorted(flat):
        if path.rsplit("/", 1)[-1] in NOISY:
            flat[path] = (flat[path] + 0.1 * rng.standard_normal(
                flat[path].shape)).astype(np.float32)
    return mp.unflatten_tree(flat)


def _inputs(cfg, shape, seed):
    """Token ids (B, S) or frames (B, S, D) from a NumPy seed."""
    rng = np.random.default_rng(seed)
    if cfg.embed_mode == "frames":
        return rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def families():
    """Per arch: both configs, the noisy reference tree and the port's
    model holding it (built lazily, once)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = _cfgs(arch)
            tree = _noisy_tree(jcfg)
            cache[arch] = (jcfg, cfg, tree, mp.from_reference(tree, cfg,
                                                              "cpu"))
        return cache[arch]
    return get


def _positions(S):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(S, dtype=np.int32), (B, S)))


def _caches_close(got, want, cfg, what):
    for u in range(cfg.num_units):
        for b, blk in want["units"].items():
            for k, leaf in blk.items():
                _close(got["units"][u][b][k], np.asarray(leaf)[u],
                       f"{what} units[{u}].{b}.{k}")
    for i in range(len(cfg.tail_pattern)):
        for k, leaf in want[f"tail{i}"].items():
            _close(got[f"tail{i}"][k], leaf, f"{what} tail{i}.{k}")


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS + ("mixtral-8x22b",
                                          "phi3.5-moe-42b-a6.6b",
                                          "xlstm-1.3b"))
def test_config_equals_reference(arch):
    assert_config_same(get_config(arch), ref_get_config(arch))
    jcfg, cfg = _cfgs(arch)
    assert_config_same(cfg, jcfg)


def test_reduced_shapes():
    _, gemma = _cfgs("gemma3-27b")
    assert (gemma.num_units, tuple(gemma.tail_pattern)) \
        == (1, ("local", "local"))
    assert P == 2 * gemma.local_window
    _, music = _cfgs("musicgen-medium")
    assert music.n_kv_heads == music.n_heads
    # the quirk the override undoes
    assert reduced(get_config("musicgen-medium")).n_kv_heads == 2


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("arch", ARCHS)
def test_first_block_matches_reference(families, arch):
    """Each kind of block once (gemma3: its first local and its global
    block), on embedded inputs: the norms (sandwich ones included), the
    mixer, the feed-forward and both residuals."""
    jcfg, cfg, tree, model = families(arch)
    pos = _positions(P)
    x = np.random.default_rng(1).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)
    seen = set()
    for i, kind in enumerate(cfg.pattern):
        if kind in seen:
            continue
        seen.add(kind)
        jblock = jax.tree.map(lambda a: a[0], tree["units"][f"b{i}"])
        want, _ = jtf._apply_block(jblock, jnp.asarray(x), jcfg, kind,
                                   jnp.asarray(pos))
        with torch.inference_mode():
            got, _, _ = tf.apply_block(model.units[0][f"b{i}"],
                                       torch.from_numpy(x), cfg, kind,
                                       torch.from_numpy(pos))
        _close(got, want, f"{arch} b{i} ({kind})", LAYER_TOL)


def test_sinusoidal_positions_match_reference_and_dynamic_form():
    d, S, off = 64, 40, 7
    table = layers.sinusoidal_positions(S, d, offset=off)
    want = np.asarray(jlayers.sinusoidal_positions(S, d, offset=off))
    assert table.dtype == torch.float32
    assert table.numpy().tobytes() == want.tobytes()
    dyn = layers.sinusoidal_positions_dynamic(
        torch.arange(off, off + S, dtype=torch.int32), d)
    # float32 angles against float64 ones: |angle| < 50, so 1e-5
    _close(dyn, want, "dynamic vs static", LAYER_TOL)
    _close(dyn, jlayers.sinusoidal_positions_dynamic(
        jnp.arange(off, off + S, dtype=jnp.int32), d), "dynamic", 1e-6)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(families, arch):
    jcfg, cfg, tree, model = families(arch)
    x, pos = _inputs(cfg, (B, P), 2), _positions(P)
    want, want_aux = jtf.forward(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got, aux = tf.forward(model, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, f"{arch} forward hidden")
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(families, arch):
    """Prefill (last-position logits and every layer's cache), then STEPS
    decode steps: token models fed the reference's greedy token (so that a
    near tie cannot split the two), frames models seeded frames."""
    jcfg, cfg, tree, model = families(arch)
    x = _inputs(cfg, (B, P), 3)
    cap = P + STEPS
    want_logits, jcache = jtf.prefill(tree, jcfg, jnp.asarray(x),
                                      capacity=cap)
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, torch.from_numpy(x),
                                   capacity=cap)
    _close(logits, want_logits, f"{arch} prefill logits")
    _caches_close(cache, jcache, cfg, f"{arch} prefill")
    decode = jax.jit(lambda p, c, x, pos: jtf.decode_step(p, jcfg, c, x, pos))
    frames = _inputs(cfg, (STEPS, B, 1), 4)
    for t in range(STEPS):
        if cfg.embed_mode == "frames":
            nxt = frames[t]
        else:
            nxt = np.array(jnp.argmax(want_logits[:, -1], axis=-1),
                           np.int32)[:, None]
        want_logits, jcache = decode(tree, jcache, jnp.asarray(nxt), P + t)
        with torch.inference_mode():
            logits, cache = tf.decode_step(model, cfg, cache,
                                           torch.from_numpy(nxt), P + t)
        _close(logits, want_logits, f"{arch} decode step {t} logits")
        _caches_close(cache, jcache, cfg, f"{arch} decode step {t}")


@pytest.mark.parametrize("arch", TOKENS)
def test_generate_greedy_matches_reference(families, arch):
    jcfg, cfg, tree, model = families(arch)
    prompts = _inputs(cfg, (B, P), 5)
    want = jserve.Server(jcfg, tree).generate(prompts, STEPS)
    got = serve.Server(cfg, model).generate(prompts, STEPS)
    assert got.dtype == np.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got, want)


def test_gemma3_window_fallback_matches_reference(families):
    """S = 12 is not a multiple of the reduced window (8): the reference
    ignores the window (full causal attention), and so does the port."""
    jcfg, cfg, tree, model = families("gemma3-27b")
    S = 12
    x, pos = _inputs(cfg, (B, S), 6), _positions(S)
    want, _ = jtf.forward(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))
    want_logits, jcache = jtf.prefill(tree, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        got, _ = tf.forward(model, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
        logits, cache = tf.prefill(model, cfg, torch.from_numpy(x))
    _close(got, want, "S % window forward")
    _close(logits, want_logits, "S % window prefill logits")
    _caches_close(cache, jcache, cfg, "S % window prefill")


def test_swapped_sandwich_norms_fail_the_comparison(families):
    """A port that applied post2 where post1 belongs (and the reverse)
    would fail the comparison: the noisy norms tell them apart."""
    jcfg, cfg, tree, _ = families("gemma3-27b")
    flat = mp.flatten_tree(tree)
    swapped = dict(flat)
    for path in flat:
        if "/post1/" in path:
            other = path.replace("/post1/", "/post2/")
            swapped[path], swapped[other] = flat[other], flat[path]
    # one RMS scale each: the unit's six blocks and the two tail blocks
    assert sum("/post1/" in p for p in flat) == 8
    bad = mp.from_reference(mp.unflatten_tree(swapped), cfg, "cpu")
    x, pos = _inputs(cfg, (B, P), 2), _positions(P)
    want, _ = jtf.forward(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got, _ = tf.forward(bad, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    with pytest.raises(AssertionError):
        _close(got, want, "swapped post norms")


# ------------------------------------------------------------------- frames
@pytest.mark.parametrize("arch", FRAMES)
def test_frames_tree_has_no_embed_and_round_trips(families, arch):
    _, cfg, tree, model = families(arch)
    assert "embed" not in tree and not hasattr(model, "embed")
    assert model.device == torch.device("cpu")
    want, got = mp.flatten_tree(tree), mp.flatten_tree(mp.to_reference(model))
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert sorted(mp.flatten_tree(mp.reference_shapes(cfg))) == sorted(want)


@pytest.mark.parametrize("arch", FRAMES)
def test_generate_refuses_a_frames_model(families, arch):
    _, cfg, _, model = families(arch)
    with pytest.raises(ValueError, match="make_decode_step"):
        serve.Server(cfg, model).generate(np.zeros((B, 4), np.int32), 2)


def test_frames_loss_and_gradients_match_jax_grad(families):
    """steps.loss_fn on a frames batch from TokenPipeline(frames_dim=D)
    (reduced musicgen), against jax.grad of the reference's loss_fn: the
    loss and every parameter's gradient within 1e-4 of the largest."""
    jcfg, cfg, tree, _ = families("musicgen-medium")
    batch = TokenPipeline(cfg.vocab_size, B, P, seed=1,
                          frames_dim=cfg.d_model).batch_view(0).value()
    assert batch["inputs"].shape == (B, P, cfg.d_model)
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


# ------------------------------------------------- chip_smoke.py phase 9
@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_serving_checks_rehearse_on_cpu(monkeypatch, arch):
    """chip_smoke.py phase 9's serving checks on the CPU at the reduced
    size, with the plain version standing in for the CUDA kernel on the
    kernel route: the run serves (tokens or frames), every attention call
    is tallied by shape, no layer's mixer differs beyond MIXER_RTOL nor the
    prefill (nor the sound route with P rounded once to bf16) beyond the
    model's FAMILY_PREFILL_RTOL, and every planted fault exceeds its
    limit (gemma3's local layers with the window ones too)."""
    from repro_torch.kernels import ops, ref

    cs = load_chip_smoke()
    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda q, k, v, *, causal, window: ref.flash_attention(
                            q, k, v, causal=causal, window=window))
    _, cfg = _cfgs(arch)
    run = cs.serve_model(torch, cfg, "cpu", requests=B, prompt=P, gen=3)
    assert run["out"].shape == (B, 3)
    assert sum(run["shapes"].values()) == cfg.num_layers
    layers_ = cs.check_layers_against_plain(torch, run)
    assert layers_["worst"]["out"] <= cs.MIXER_RTOL
    kinds = list(dict.fromkeys(cfg.pattern))
    want = {f"layer{cfg.pattern.index(k)} {n}"
            for k in kinds for n in cs.attention_faults(cfg, k)}
    assert set(layers_["planted"]) == want
    if arch == "gemma3-27b":
        assert "layer0 window dropped" in want and "layer5 causal off" in want
    faults = cs.attention_faults(cfg, "attn")
    assert sorted(faults) == ["causal off", "kv heads rolled"]
    sound = {"P to 8 bits": cs.rounded_p_attention(torch, cs.SOUND_P_BITS,
                                                   block=8)}
    # FAMILY_PREFILL_RTOL is the full-width models'; at this size the
    # planted faults move the frames models' prefill by only 2e-2 to 3e-2,
    # so the rehearsal holds it to one bf16 step a layer, compounding
    agree = cs.check_model_against_plain(
        torch, run, gen=3, rtol=(1 + 2.0 ** -8) ** cfg.num_layers - 1,
        faults=faults, sound=sound)
    assert agree["worst_rel_err"] <= agree["limit"]
    assert min(agree["planted"].values()) > agree["limit"]
    assert 0 < agree["stand_in"]["P to 8 bits"] <= agree["limit"]
    bound = cs.decode_bound(run["model"], cfg, B, P, 3)
    assert bound["weight_bytes"] == 4 * sum(
        p.numel() for n, p in run["model"].named_parameters()
        if n != "embed")


def test_chip_smoke_prefill_limits_and_decode_bound():
    cs = load_chip_smoke()
    # a limit per phase 9 model; gemma3, whose scaled embeddings keep the
    # stream large as recurrentgemma's do, stays under phase 5's argument
    # ((1 + 2^-9)^layers - 1, which MODEL_RTOL rounds at 26 layers)
    assert set(cs.FAMILY_PREFILL_RTOL) == {a for a, _, _ in cs.FAMILY_RUNS}
    assert cs.FAMILY_PREFILL_RTOL["gemma3-27b"] <= cs.MODEL_RTOL
    assert cs.SOUND_P_BITS == 8 and cs.CONTROL_P_BITS < cs.SOUND_P_BITS
    # gemma3: a local layer's decode reads at most its window
    _, cfg = _cfgs("gemma3-27b")
    model = tf.Transformer(cfg, "meta")
    got = cs.decode_bound(model, cfg, 1, 100, 1)
    per_position = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    local = cfg.num_layers - cfg.pattern.count("global")
    assert got["cache_bytes"] == per_position * (
        local * cfg.local_window + (cfg.num_layers - local) * 101)


@pytest.mark.parametrize("window", [None, 5])
def test_chip_smoke_rounded_p_attention(window):
    """The stand-in attention of phase 9's sound and control routes: P
    rounded to 8 significant bits is bf16's rounding to nearest even, and
    the route equals the plain version within one bf16 step of P; kept
    to 4 bits it departs by more."""
    from repro_torch.kernels import ref

    cs = load_chip_smoke()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    assert torch.equal(cs.round_to_bits(torch, x.clone(), 8),
                       x.bfloat16().float())
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, 24, 16))
                                .astype(np.float32)) for h in (4, 2, 2))
    want = ref.flash_attention(q, k, v, window=window)
    errs = {bits: float((cs.rounded_p_attention(torch, bits, block=8)(
        q, k, v, window=window) - want).abs().max())
        for bits in (cs.SOUND_P_BITS, cs.CONTROL_P_BITS)}
    assert 0 < errs[cs.SOUND_P_BITS] <= 2.0 ** -8 * float(v.abs().max())
    assert errs[cs.CONTROL_P_BITS] > 4 * errs[cs.SOUND_P_BITS]


def test_chip_smoke_frames_training_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py phase 9's training on reduced musicgen, on the CPU,
    with the plain versions standing in for the raw launchers on the
    kernel route (so the autograd Function runs): one layer's gradients on
    a frames batch agree across the routes, the planted attention
    backward fault (the causal mask off; musicgen has no window and no
    scan) exceeds the limit, and launch.train.run trains on frames with the
    launches of one forward per layer twice (remat) and one backward."""
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ops, ref

    cs = load_chip_smoke()

    def fwd(q, k, v, *, causal=True, window=None, return_lse=False):
        out = ref.flash_attention(q, k, v, causal=causal, window=window)
        return (out, torch.zeros(q.shape[:3])) if return_lse else out

    def bwd(q, k, v, out, dout, lse, *, causal=True, window=None):
        return ref.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       window=window)

    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(cuda_fa, "flash_attention", fwd)
    monkeypatch.setattr(cuda_fa, "flash_attention_bwd", bwd)
    _, cfg = _cfgs("musicgen-medium")
    assert cs.training_batch(cfg, 0, 2, 16)["inputs"].shape \
        == (2, 16, cfg.d_model)
    grads = cs.check_training_gradients(torch, cfg, "cpu", batch=2, seq=16)
    assert grads["layers"] == 1 and grads["worst_rel_err"] < 1e-5
    assert sorted(grads["planted"]) == [
        "attention backward with the causal mask off"]
    assert all(e > cs.GRAD_RTOL for e in grads["planted"].values())
    run = cs.train_model(torch, cfg, "cpu", batch=2, seq=16, warmup=1,
                         steps=2)
    assert len(run["losses"]) == 3
    assert cs.launches_per_step(get_config("musicgen-medium")) == {
        "lru_scan": 0, "lru_scan_bwd": 0, "flash_attention": 96,
        "flash_attention_bwd": 48}


def test_chip_smoke_phase9_attention_shapes():
    """The attention calls phase 9 expects of each full-width run: one per
    attention layer, gemma3's 52 local layers with their window (4096 is a
    multiple of 1024) and its 10 global ones without."""
    cs = load_chip_smoke()
    runs = {arch: cs.family_attention_shapes(cs.family_config(arch, layers),
                                             requests)
            for arch, layers, requests in cs.FAMILY_RUNS}
    S = cs.FAMILY_PROMPT
    assert runs["gemma3-27b"] == {(2, 32, 16, S, 128, 1024): 52,
                                  (2, 32, 16, S, 128, None): 10}
    assert runs["starcoder2-7b"] == {(8, 36, 4, S, 128, None): 32}
    assert runs["qwen1.5-110b"] == {(2, 64, 8, S, 128, None): 20}
    assert runs["internvl2-76b"] == {(2, 64, 8, S, 128, None): 32}
    assert runs["musicgen-medium"] == {(8, 24, 24, S, 64, None): 48}
