"""The port's MoE family against the JAX package: ``nn/moe.py`` (routing,
the dense and the dropping dispatch, grouped or not) and the two MoE
architectures, ``mixtral-8x22b`` (sliding-window attention) and
``phi3.5-moe-42b-a6.6b``, on their reduced configs, through forward,
prefill, decode, greedy generation and the training loss's gradients.

The reference initialises every norm scale at zero; each test adds seeded
noise to them (as ``tests/test_torch_families.py`` does) before carrying
the tree across with ``models.params.from_reference``. Inputs come from a
NumPy seed. Reduced mixtral runs a prompt of 16, twice its reduced
window (8), so that the window is applied.

On the CPU both packages compute in float32 and the port takes its plain
paths. Tolerances: the routing's top-k indices equal and its weights and
aux within 1e-6; one MoE layer within 1e-5; the dropping path's gathered
token indices equal (the port's stable sort keeps the reference's
``top_k`` tie order, lower index first); across the model 1e-4; the loss
and every gradient, the routers' included, within 1e-4 of the largest.
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
from repro.nn import moe as jmoe  # noqa: E402
from _torch_parity import load_chip_smoke  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.train.data import TokenPipeline  # noqa: E402

ARCHS = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")
IMPLS = ("dense", "dropping")
B, P, STEPS = 2, 16, 4
ROUTE_TOL, LAYER_TOL, MODEL_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-4, 1e-4
# the dropping path's settings: moe_groups 0 (one group) and 4, at the
# default capacity (tokens dropped) and at 8 (C == Tl, none dropped)
DROPPING = [(g, cf) for g in (0, 4) for cf in (1.25, 8.0)]


def _close(got, want, what="", tol=MODEL_TOL):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=what)


def _cfgs(arch, **kw):
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _noisy_tree(jcfg, seed=0):
    """The reference's initial weights with N(0, 0.1^2) noise added to
    every norm scale."""
    flat = mp.flatten_tree(jax.tree.map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 100)
    for path in sorted(flat):
        if path.rsplit("/", 1)[-1] == "scale":
            flat[path] = (flat[path] + 0.1 * rng.standard_normal(
                flat[path].shape)).astype(np.float32)
    return mp.unflatten_tree(flat)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def families():
    """Per (arch, impl): both configs, the noisy reference tree and the
    port's model holding it (built lazily, once)."""
    cache = {}

    def get(arch, impl="dense"):
        if (arch, impl) not in cache:
            jcfg, cfg = _cfgs(arch, moe_impl=impl)
            tree = _noisy_tree(jcfg)
            cache[arch, impl] = (jcfg, cfg, tree,
                                 mp.from_reference(tree, cfg, "cpu"))
        return cache[arch, impl]
    return get


def _moe_layer(arch, seed=0, **kw):
    """One reference MoE layer's weights (init_moe) on ``arch``'s reduced
    config, the port's ``MoE`` holding them, and (B, P, D) inputs."""
    jcfg, cfg = _cfgs(arch, **kw)
    tree = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), jcfg))
    p = mp.load_tree(moe.MoE(cfg, "cpu"), tree)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, tree, p, x


def _positions(S):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(S, dtype=np.int32), (B, S)))


def _caches_close(got, want, cfg, what):
    for u in range(cfg.num_units):
        for b, blk in want["units"].items():
            for k, leaf in blk.items():
                _close(got["units"][u][b][k], np.asarray(leaf)[u],
                       f"{what} units[{u}].{b}.{k}")


# ------------------------------------------------------------------ configs
def test_reduced_configs_exercise_the_window_and_the_experts():
    _, mix = _cfgs("mixtral-8x22b")
    assert tuple(mix.pattern) == ("swa",) and mix.swa_window == 8
    assert P > mix.swa_window and P % mix.swa_window == 0
    _, phi = _cfgs("phi3.5-moe-42b-a6.6b")
    for cfg in (mix, phi):
        assert (cfg.ffn, cfg.n_experts, cfg.top_k) == ("moe", 4, 2)
    assert get_config("mixtral-8x22b").n_experts == 8
    assert get_config("phi3.5-moe-42b-a6.6b").n_experts == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_round_trips_with_stacked_routers(families, arch):
    """units/b0/ffn/{router,w1,w3,w2}, stacked over units, both ways,
    byte-identical; the router float32 (the reference's, always)."""
    _, cfg, tree, model = families(arch)
    want, got = mp.flatten_tree(tree), mp.flatten_tree(mp.to_reference(model))
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    ffe = cfg.d_ff_expert
    assert want["units/b0/ffn/router"].shape == (cfg.num_units, cfg.d_model,
                                                 cfg.n_experts)
    assert want["units/b0/ffn/w2"].shape == (cfg.num_units, cfg.n_experts,
                                             ffe, cfg.d_model)
    assert sorted(mp.flatten_tree(mp.reference_shapes(cfg))) == sorted(want)


def test_router_stays_float32_where_weights_are_bf16(monkeypatch):
    """A serving model on a card holds its weights in bf16 (weight_dtype);
    the router stays float32, as the reference computes it."""
    monkeypatch.setattr(moe, "weight_dtype",
                        lambda cfg, device, trainable=False: torch.bfloat16)
    p = moe.MoE(_cfgs("mixtral-8x22b")[1], "meta")
    assert p.router.dtype == torch.float32
    assert {p.w1.dtype, p.w3.dtype, p.w2.dtype} == {torch.bfloat16}


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch):
    jcfg, cfg, tree, p, x = _moe_layer(arch)
    xt = x.reshape(B * P, cfg.d_model)
    want = jmoe._routing(tree, jnp.asarray(xt), jcfg)
    with torch.inference_mode():
        got = moe._routing(p, torch.from_numpy(xt), cfg)
    combine, top_idx, top_w, aux = got
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(want[1]))
    for name, g, w in (("combine", combine, want[0]), ("top_w", top_w,
                                                       want[2]),
                       ("aux", aux, want[3])):
        _close(g, w, f"{arch} routing {name}", ROUTE_TOL)


def test_routing_ties_go_to_the_lower_index():
    """A zero router gives every expert the same probability: the
    reference's top_k takes the lowest indices, and so does the port
    (torch.topk promises no order among ties)."""
    jcfg, cfg, tree, p, x = _moe_layer("phi3.5-moe-42b-a6.6b")
    tree = dict(tree, router=np.zeros_like(tree["router"]))
    with torch.no_grad():
        p.router.zero_()
    xt = x.reshape(B * P, cfg.d_model)
    want = jmoe._routing(tree, jnp.asarray(xt), jcfg)
    with torch.inference_mode():
        _, top_idx, top_w, aux = moe._routing(p, torch.from_numpy(xt), cfg)
    assert (np.asarray(want[1]) == np.arange(cfg.top_k)).all()
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(want[1]))
    _close(top_w, want[2], "tied top_w", ROUTE_TOL)
    _close(aux, want[3], "tied aux", ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    jcfg, cfg, tree, p, x = _moe_layer(arch)
    want, want_aux = jmoe.moe_dense(tree, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got, aux = moe.moe_dense(p, torch.from_numpy(x), cfg)
    _close(got, want, f"{arch} moe_dense", LAYER_TOL)
    _close(aux, want_aux, f"{arch} moe_dense aux", ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups,capacity", DROPPING)
def test_moe_dropping_matches_reference(arch, groups, capacity):
    jcfg, cfg, tree, p, x = _moe_layer(arch, moe_groups=groups,
                                       capacity_factor=capacity)
    want, want_aux = jmoe.moe_dropping(tree, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got, aux = moe.moe_dropping(p, torch.from_numpy(x), cfg)
    _close(got, want, f"{arch} moe_dropping G={groups} cf={capacity}",
           LAYER_TOL)
    _close(aux, want_aux, "moe_dropping aux", ROUTE_TOL)


@pytest.mark.parametrize("groups,capacity", DROPPING)
def test_dropping_gathers_the_reference_tokens(groups, capacity):
    """Per group and expert the C selected token indices equal the
    reference's ``top_k(gate_l.T, C)``, the zero-weight fillers included
    (at capacity 8 most slots are ties at 0), and their weights within
    1e-6."""
    jcfg, cfg, tree, p, x = _moe_layer("mixtral-8x22b", moe_groups=groups,
                                       capacity_factor=capacity)
    T = B * P
    xt = x.reshape(T, cfg.d_model)
    combine = jmoe._routing(tree, jnp.asarray(xt), jcfg)[0]
    G = groups if groups > 1 else 1
    with torch.inference_mode():
        got_combine = moe._routing(p, torch.from_numpy(xt), cfg)[0]
        sel_w, sel_idx = moe.dispatch(got_combine, cfg)
    assert sel_idx.shape[:2] == (G, cfg.n_experts)
    for g, gate in enumerate(np.asarray(combine).reshape(G, T // G, -1)):
        w, idx = jax.lax.top_k(jnp.asarray(gate).T, sel_idx.shape[2])
        np.testing.assert_array_equal(sel_idx[g].numpy(), np.asarray(idx))
        _close(sel_w[g], w, f"group {g} sel_w", ROUTE_TOL)
    if capacity == 8.0:
        # every token in every expert's slots: all but top_k of each
        # token's E weights are ties at 0
        assert sel_idx.shape[2] == T // G
        assert int((sel_w == 0).sum()) == T * (cfg.n_experts - cfg.top_k)


def test_moe_dropping_close_to_dense_at_high_capacity():
    """The reference's check (tests/test_perf_variants.py), on the port:
    with capacity >= T the dropping dispatch loses no tokens, so it equals
    dense."""
    jcfg, cfg, tree, p, x = _moe_layer("mixtral-8x22b", seed=4,
                                       capacity_factor=8.0)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        yd, ad = moe.moe_dense(p, xt, cfg)
        yq, aq = moe.moe_dropping(p, xt, cfg)
    np.testing.assert_allclose(yd.numpy(), yq.numpy(), atol=1e-4, rtol=1e-3)
    assert float(ad) == float(aq)


def test_moe_grouped_dispatch_matches_global():
    """The reference's check (tests/test_perf_variants.py), on the port:
    at that capacity 4 groups give what one group gives."""
    jcfg, cfg, tree, p, _ = _moe_layer("mixtral-8x22b", seed=6,
                                       capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, P, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        y1, _ = moe.moe_dropping(p, x, dataclasses.replace(cfg, moe_groups=0))
        y4, _ = moe.moe_dropping(p, x, dataclasses.replace(cfg, moe_groups=4))
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=1e-4, rtol=1e-3)


def test_dropping_drops_tokens_at_decode_as_the_reference():
    """The reference's quirk at decode: C is computed from the B tokens of
    one step, so with B = 2 each of 4 experts keeps ceil(2 / 4 * 2 * 1.25)
    = 2 slots, and a token whose expert is full gets no output from it.
    The port does the same."""
    jcfg, cfg, tree, p, x = _moe_layer("mixtral-8x22b")
    step = x[:, :1]
    want, _ = jmoe.moe_dropping(tree, jnp.asarray(step), jcfg)
    with torch.inference_mode():
        got, _ = moe.moe_dropping(p, torch.from_numpy(step), cfg)
        sel_w, _ = moe.dispatch(moe._routing(
            p, torch.from_numpy(step[:, 0]), cfg)[0], cfg)
    assert sel_w.shape == (1, cfg.n_experts, 2)
    _close(got, want, "one decode step", LAYER_TOL)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(families, arch, impl):
    """The hidden state and the aux (the mean over the blocks' losses,
    nonzero) within 1e-4."""
    jcfg, cfg, tree, model = families(arch, impl)
    x, pos = _tokens(cfg, (B, P), 2), _positions(P)
    want, want_aux = jtf.forward(tree, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got, aux = tf.forward(model, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, f"{arch} {impl} forward hidden")
    _close(aux, want_aux, f"{arch} {impl} forward aux")
    assert float(aux) > 0.5


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(families, arch, impl):
    """Prefill (last-position logits and every layer's cache), then STEPS
    decode steps fed the reference's greedy token."""
    jcfg, cfg, tree, model = families(arch, impl)
    x = _tokens(cfg, (B, P), 3)
    cap = P + STEPS
    want_logits, jcache = jtf.prefill(tree, jcfg, jnp.asarray(x),
                                      capacity=cap)
    with torch.inference_mode():
        logits, cache = tf.prefill(model, cfg, torch.from_numpy(x),
                                   capacity=cap)
    _close(logits, want_logits, f"{arch} {impl} prefill logits")
    _caches_close(cache, jcache, cfg, f"{arch} {impl} prefill")
    decode = jax.jit(lambda p, c, x, pos: jtf.decode_step(p, jcfg, c, x, pos))
    for t in range(STEPS):
        nxt = np.array(jnp.argmax(want_logits[:, -1], axis=-1),
                       np.int32)[:, None]
        want_logits, jcache = decode(tree, jcache, jnp.asarray(nxt), P + t)
        with torch.inference_mode():
            logits, cache = tf.decode_step(model, cfg, cache,
                                           torch.from_numpy(nxt), P + t)
        _close(logits, want_logits, f"{arch} {impl} decode step {t} logits")
        _caches_close(cache, jcache, cfg, f"{arch} {impl} decode step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(families, arch):
    jcfg, cfg, tree, model = families(arch)
    prompts = _tokens(cfg, (B, P), 5)
    want = jserve.Server(jcfg, tree).generate(prompts, STEPS)
    got = serve.Server(cfg, model).generate(prompts, STEPS)
    assert got.dtype == np.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(families, arch, impl):
    """steps.loss_fn (cross entropy plus 0.01 x aux) and every parameter's
    gradient, the routers' included, against jax.grad of the reference's
    loss_fn, within 1e-4 of the largest; the aux is nonzero and the
    routers' gradients too."""
    jcfg, cfg, tree, _ = families(arch, impl)
    batch = TokenPipeline(cfg.vocab_size, B, P, seed=1).batch_view(0).value()
    (jl, jm), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, batch)
    model = mp.from_reference(tree, cfg, "cpu", trainable=True)
    loss, metrics = steps.loss_fn(model, cfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]), rtol=GRAD_TOL)
    assert float(metrics["aux"].detach()) > 0.5
    grads = mp.flatten_tree(mp.named_to_reference(
        {n: p.grad for n, p in model.named_parameters()}))
    want = mp.flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, atol=GRAD_TOL * top, rtol=0,
                                   err_msg=k)
    router = grads["units/b0/ffn/router"]
    assert all(float(np.abs(r).max()) > 0 for r in router)


def test_aux_gradient_reaches_the_router_alone():
    """The aux term alone (no cross entropy) has a gradient into the
    router through pbar, the mean probability, and none into the experts;
    it equals the reference's."""
    jcfg, cfg, tree, p, x = _moe_layer("phi3.5-moe-42b-a6.6b")
    xt = x.reshape(B * P, cfg.d_model)
    jg = jax.grad(lambda t: jmoe._routing(t, jnp.asarray(xt), jcfg)[3])(
        jax.tree.map(jnp.asarray, tree))
    p.requires_grad_(True)
    moe._routing(p, torch.from_numpy(xt), cfg)[3].backward()
    _close(p.router.grad, jg["router"], "aux d router", ROUTE_TOL)
    assert float(p.router.grad.abs().max()) > 0
    assert all(getattr(p, n).grad is None for n in ("w1", "w3", "w2"))


def test_microbatch_metrics_keep_the_reference_quirk(families):
    """With microbatches the reference reports ce as the mean of the
    splits' whole losses (the aux term inside) and aux 0; the port's train
    step reports the same, and the loss equals the reference's."""
    jcfg, cfg, tree, _ = families("phi3.5-moe-42b-a6.6b")
    jcfg = dataclasses.replace(jcfg, microbatches=2)
    cfg = dataclasses.replace(cfg, microbatches=2)
    batch = TokenPipeline(cfg.vocab_size, 2 * B, P, seed=3).batch_view(
        0).value()
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    jstate["params"] = jax.tree.map(jnp.asarray, tree)
    _, jm = jsteps.make_train_step(jcfg)(jstate, batch)
    state = steps.state_of(mp.from_reference(tree, cfg, "cpu",
                                             trainable=True))
    _, m = steps.make_train_step(cfg)(state, batch)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]),
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(float(m["loss"]), float(m["ce"]), rtol=0)


# --------------------------------------------------------------- launch
def test_train_refuses_a_full_size_model_that_cannot_fit(monkeypatch):
    """launch.train's depth check: phi3.5-moe needs 624 GiB of float32
    training state and 2 full-width layers fit 75 % of 80 GiB; mixtral's
    one layer (2.5 B parameters, 37 GiB) fits. On an 80 GiB card the full
    model is refused with that depth, as is 3 layers' state (within the
    card but over the 75 % that leaves room for activations), and the cut
    one passes."""
    phi = get_config("phi3.5-moe-42b-a6.6b")
    assert ptrain.STATE_BYTES_PER_PARAM * phi.param_count() > 600 * 2**30
    assert ptrain.depth_that_fits(phi, 80 * 2**30) == 2
    assert ptrain.depth_that_fits(get_config("mixtral-8x22b"),
                                  80 * 2**30) == 1
    cut = dataclasses.replace(phi, num_layers=2)
    assert ptrain.STATE_BYTES_PER_PARAM * cut.param_count() \
        <= 0.75 * 80 * 2**30
    # the check is for a card; the host is not measured
    ptrain.check_fits(phi, torch.device("cpu"))

    class Card:
        total_memory = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Card)
    with pytest.raises(SystemExit, match="cut its depth to 2 of its 32"):
        ptrain.check_fits(phi, torch.device("cuda"))
    three = dataclasses.replace(phi, num_layers=3)
    assert 0.75 * 80 * 2**30 < ptrain.STATE_BYTES_PER_PARAM \
        * three.param_count() <= 80 * 2**30
    with pytest.raises(SystemExit, match="cut its depth to 2 of its 3 "):
        ptrain.check_fits(three, torch.device("cuda"))
    ptrain.check_fits(cut, torch.device("cuda"))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_commands_accept_the_moe_names(arch, monkeypatch, tmp_path):
    """``--arch`` takes both MoE names: serve answers on the reduced config
    and train runs 30 steps (its loss must fall), on the CPU."""
    import sys

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--device",
                                      "cpu", "--requests", "2",
                                      "--prompt-len", "16", "--gen", "2"])
    serve.main()
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--device", "cpu", "--steps", "30",
        "--batch", "4", "--seq", "32", "--ckpt-every", "100",
        "--ckpt-dir", str(tmp_path)])
    ptrain.main()


# ------------------------------------------------ chip_smoke.py phase 10
def _kernel_stand_ins(monkeypatch):
    """The plain version standing in for the CUDA kernel on the kernel
    route, so that chip_smoke's checks run on the CPU."""
    from repro_torch.kernels import ops, ref

    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda q, k, v, *, causal, window: ref.flash_attention(
                            q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_moe_checks_rehearse_on_cpu(monkeypatch, arch):
    """chip_smoke.py phase 10's serving checks on the CPU at the reduced
    size: the run serves with one attention call per layer (mixtral's with
    its window), the MoE layer's checks pass (dropping at capacity 8 equal
    to dense, 4 groups to one, two calls bit-equal), the routes agree,
    and every planted fault and the 4-bit control exceed the limit while
    the sound route stays within it; here the limit is one bf16 step a
    layer, compounding (the rehearsal's float32 routes agree to 1e-6)."""
    cs = load_chip_smoke()
    _kernel_stand_ins(monkeypatch)
    _, cfg = _cfgs(arch)
    run = cs.serve_model(torch, cfg, "cpu", requests=B, prompt=P, gen=3)
    window = cfg.swa_window if arch == "mixtral-8x22b" else None
    assert run["shapes"] == {(B, cfg.n_heads, cfg.n_kv_heads, P,
                              cfg.resolved_head_dim, window): cfg.num_layers}
    layer = cs.check_moe_layer(torch, run)
    assert layer["bit_equal"] and max(layer["errs"].values()) <= 1e-6
    assert layer["aux"] > 0.5 and layer["timed"] is None
    routing = cs.routing_layer_flips(torch, run)
    assert set(routing["share"]) == {"kernel", "P to 8 bits",
                                     "router in bf16"}
    assert all(len(v) == cfg.num_layers
               for v in routing["per_layer"].values())
    assert routing["share"]["kernel"] == 0.0
    monkeypatch.setattr(cs, "MOE_PREFILL_RTOL",
                        (1 + 2.0 ** -8) ** cfg.num_layers - 1)
    variants = cs.moe_prefill_variants(torch, cfg)
    assert {n: (g, f) for n, (g, _, f) in variants.items()} == {
        "causal off": ("fault", None), "kv heads rolled": ("fault", None),
        "top_w not renormalised": ("fault", "top_w not renormalised"),
        "the (k+1)-th expert chosen": ("fault",
                                       "the (k+1)-th expert chosen"),
        "router in bf16": ("finding", "router in bf16"),
        "P to 8 bits": ("sound", None), "P to 4 bits": ("control", None)}
    agree = cs.check_moe_prefill(torch, run, cfg, variants)
    got = agree["variants"]
    assert got["kernel"]["err"] <= 1e-6 and got["kernel"]["flips"] == 0.0
    assert agree["free"]["err"] <= 1e-6 and agree["free"]["flips"] == 0.0
    assert len(got["kernel"]["per_layer"]) == cfg.num_layers
    # the fault is in the choice: every token's set differs from the plain
    # route's, and the replay keeps it
    assert got["the (k+1)-th expert chosen"]["flips"] == 1.0
    drop = dataclasses.replace(cfg, moe_impl="dropping")
    variants = cs.moe_prefill_variants(torch, drop)
    assert set(variants) == {"sel_w left out", "P to 8 bits", "P to 4 bits"}
    agree = cs.check_moe_prefill(torch, run, drop, variants)
    assert agree["impl"] == "dropping"
    assert agree["variants"]["kernel"]["slot_flips"] == 0.0
    assert agree["variants"]["sel_w left out"]["err"] \
        > cs.MOE_PREFILL_RTOL


def test_chip_smoke_routing_replay_takes_the_plain_choices():
    """routing_tap's replay: a prefill replaying its own route's tap
    routes exactly as the model does; replaying another route's tap (here
    one whose (k+1)-th expert was chosen) takes that route's expert sets
    and dropping slots, weighted by this route's own probabilities, while
    recording the sets this route would have chosen."""
    cs = load_chip_smoke()
    _, cfg, _, p, x = _moe_layer("phi3.5-moe-42b-a6.6b", moe_impl="dropping")
    h = torch.from_numpy(x)
    with torch.inference_mode():
        want = moe.moe_forward(p, h, cfg)[0]
        with cs.routing_tap(torch) as plain:
            assert torch.equal(moe.moe_forward(p, h, cfg)[0], want)
        with cs.routing_tap(torch, plain) as same:
            assert torch.equal(moe.moe_forward(p, h, cfg)[0], want)
        with cs.routing_tap(torch, fault="the (k+1)-th expert chosen") \
                as other:
            moe._routing(p, h.reshape(B * P, -1), cfg)
            other_out = moe.moe_forward(p, h, cfg)[0]
        with cs.routing_tap(torch, other) as replayed:
            combine = moe._routing(p, h.reshape(B * P, -1), cfg)[0]
            replayed_out = moe.moe_forward(p, h, cfg)[0]
    assert cs.flip_share(same.sets, plain.sets) == 0.0
    assert cs.flip_share(same.slots, plain.slots) == 0.0
    # the replayed route records its own choice, and routes by the other's
    assert cs.flip_share(replayed.sets[1:], plain.sets) == 0.0
    assert cs.flip_share(other.sets[1:], plain.sets) == 1.0
    used = (combine > 0).nonzero()[:, 1].reshape(B * P, cfg.top_k)
    assert torch.equal(used.byte(), other.sets[0])
    assert torch.allclose(combine.sum(-1), torch.ones(B * P))
    assert torch.equal(replayed_out, other_out)
    assert not torch.equal(replayed_out, want)
    assert moe._routing.__name__ == "_routing"
    assert moe.dispatch.__name__ == "dispatch"


def test_chip_smoke_routing_faults_and_flips():
    """The planted routing faults do what they name, against the port's
    routing on the same layer, and the flip share counts (token, layer)
    pairs whose expert sets differ."""
    cs = load_chip_smoke()
    _, cfg, _, p, x = _moe_layer("phi3.5-moe-42b-a6.6b")
    xt = torch.from_numpy(x.reshape(B * P, cfg.d_model))

    def routed(fault=None):
        with cs.routing_tap(torch, fault=fault) as tap:
            out = moe._routing(p, xt, cfg)
            moe._routing(p, xt, cfg)
        return out, tap
    with torch.inference_mode():
        want, a = routed()
        got = {n: routed(n) for n in cs.MOE_ROUTING_FAULTS}
        sel_w, _ = moe.dispatch(want[0], cfg)
        with cs.routing_tap(torch, fault="sel_w left out"):
            left_out, _ = moe.dispatch(want[0], cfg)
    assert torch.equal(want[1], moe._routing(p, xt, cfg)[1])
    (w, idx, top_w, _), _ = got["top_w not renormalised"]
    assert torch.equal(idx, want[1])
    assert bool((top_w.sum(-1) < 1).all())
    (_, kth, _, _), b = got["the (k+1)-th expert chosen"]
    assert torch.equal(kth[:, 0], want[1][:, 0])
    assert not bool((kth[:, 1] == want[1][:, 1]).any())
    assert torch.allclose(got["router in bf16"][0][0], want[0], atol=2e-2)
    assert torch.equal(got["sel_w left out"][0][0], want[0])
    assert bool((left_out == 1).all()) and bool((sel_w < 1).any())
    assert cs.flip_share(a.sets, a.sets) == 0.0
    assert cs.flip_share(a.sets, b.sets) == 1.0
    assert len(a.sets) == 2


def test_chip_smoke_moe_training_rehearses_on_cpu(monkeypatch):
    """Phase 10's training on reduced phi3.5-moe, on the CPU, with the
    plain versions standing in for the raw launchers on the kernel route:
    launch.train.run takes 1 + 2 steps with one forward per layer twice
    (remat) and one backward a step, and the next batch's loss holds a
    nonzero aux whose gradient reaches both layers' routers."""
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
    _, cfg = _cfgs(cs.MOE_TRAIN_ARCH)
    assert cfg.num_layers == cs.MOE_TRAIN_LAYERS
    run = cs.train_model(torch, cfg, "cpu", batch=2, seq=16, warmup=1,
                         steps=2)
    assert len(run["losses"]) == 3
    assert cs.launches_per_step(cfg) == {
        "lru_scan": 0, "lru_scan_bwd": 0, "flash_attention": 4,
        "flash_attention_bwd": 2}
    aux = cs.check_aux_gradients(torch, cfg, run["state"]["params"],
                                 cs.training_batch(cfg, 3, 2, 16))
    assert aux["aux"] > 0.5 and len(aux["router_grad_max"]) == 2


def test_chip_smoke_phase10_runs():
    """The attention calls phase 10 expects of each full-width run, one
    per layer: mixtral's 10 with the window (8192 is a multiple of 4096),
    phi3.5-moe's 20 without; its training shape; and the depth cuts fit
    the card's 80 GB in bf16 (1.3-2.5 B parameters a layer)."""
    cs = load_chip_smoke()
    runs = {arch: cs.family_attention_shapes(cs.family_config(arch, layers),
                                             requests, prompt)
            for arch, layers, requests, prompt in cs.MOE_RUNS}
    assert runs == {
        "mixtral-8x22b": {(1, 48, 8, 8192, 128, 4096): 10},
        "phi3.5-moe-42b-a6.6b": {(2, 32, 8, 4096, 128, None): 20}}
    # one prefill limit for both models and dispatches, and a bf16 router
    # must flip more tokens than either sound route
    assert 0 < cs.MOE_PREFILL_RTOL < 1 and cs.BF16_ROUTER_FLIPS > 1
    for arch, layers, _, _ in cs.MOE_RUNS:
        assert 2 * cs.family_config(arch, layers).param_count() < 56e9
    cfg = cs.family_config(cs.MOE_TRAIN_ARCH, cs.MOE_TRAIN_LAYERS)
    assert 16 * cfg.param_count() < 46e9
