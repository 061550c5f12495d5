"""The port's training path against the JAX package: optimizer, loss,
data, compression, ``bf16_backward_scope``, the train step, the driver and
checkpoints that cross between the packages.

Both packages get the same NumPy inputs (and the reference's initial
weights, carried across with ``models.params.from_reference``); on the CPU
both compute in float32 and the port takes its plain paths, differentiated
by autograd where the reference uses ``jax.grad``. Tolerances, each with
its reason, are stated beside the assertions.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.train import compression, data, loss, optimizer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

from _torch_parity import assert_same  # noqa: E402

RG, QWEN = "recurrentgemma-2b", "qwen2.5-14b"
# an optimizer whose first steps move the weights visibly (the default
# warms up over 100 steps from lr 3e-6), with a decay large enough that
# decaying a leaf or not differs by far more than the tolerance
OC = {"lr": 1e-2, "warmup_steps": 1, "weight_decay": 0.5}
# the same for whole train steps, with eps 1e-5: some gradients are exactly
# 0 in exact arithmetic (a key bias shifts every score of a query alike,
# and softmax ignores the shift), so both packages compute rounding noise
# there (about 1e-10), which AdamW with eps 1e-8 turns into steps of +-lr
# whose signs depend on the order of the float sums; eps 1e-5 keeps such
# noise at 1e-5 lr while real gradients (1e-4 and up) still take about
# full steps. test_adamw_three_steps_match_reference covers eps 1e-8.
OC_STEP = dict(OC, eps=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is faster than eight, and the
    suite runs several workers on one host, whose threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _ref_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(seed)))


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _close_trees(got, want, what, atol, rtol=0.0):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float32),
                                   np.asarray(w[k], np.float32), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {k}")


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("oc", [{}, OC, {"warmup_steps": 0,
                                         "total_steps": 50}])
def test_schedule_matches_reference(oc):
    # float32 both sides, the same operations in the same order: equal
    ocj, ocp = jopt.OptConfig(**oc), optimizer.OptConfig(**oc)
    for step in (0, 1, 2, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        want = np.float32(jopt.schedule(ocj, jnp.asarray(step, jnp.int32)))
        assert optimizer.schedule(ocp, step) == want, step


def test_weight_decay_follows_the_reference_tree():
    _, cfg = _cfgs(RG, num_layers=5)
    model = tf.Transformer(cfg, "meta", trainable=True)
    tree = mp.reference_shapes(cfg)
    flat = mp.flatten_tree(tree)
    for name, p in model.named_parameters():
        path, _ = mp._reference_path(name)
        assert optimizer.decays(name, p) == (flat[path].ndim >= 2), name
    # the trap: a unit's vectors decay (stacked 2-d leaves), a tail's not
    assert optimizer.decays("units.0.b0.mixer.a_param",
                            torch.zeros(4)) is True
    assert optimizer.decays("tail0.mixer.a_param", torch.zeros(4)) is False
    assert optimizer.decays("final_norm.scale", torch.zeros(4)) is False


def _grad_trees(tree, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape))
                         .astype(np.float32), tree) for _ in range(n)]


def test_adamw_three_steps_match_reference():
    """Three AdamW steps on reduced recurrentgemma-2b (one stacked unit and
    two tail blocks, so stacked-unit and tail vectors both occur) with the
    same gradients: parameters, moments and norms within 1e-6 (float32,
    the same operations; the sums over leaves run in another order)."""
    jcfg, cfg = _cfgs(RG, num_layers=5)
    tree = _ref_tree(jcfg)
    grads = _grad_trees(tree, 3, 1)
    ocj, ocp = jopt.OptConfig(**OC), optimizer.OptConfig(**OC)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init_opt_state(jparams)
    model = mp.from_reference(tree, cfg, "cpu", trainable=True)
    state = optimizer.init_opt_state(model)
    for g in grads:
        jparams, jstate, jnorm = jopt.adamw_update(
            ocj, jparams, jax.tree.map(jnp.asarray, g), jstate)
        named = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        mp.load_named(named, g)
        for n, p in model.named_parameters():
            p.grad = named[n]
        norm = optimizer.adamw_update(ocp, model, state)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    _close_trees(mp.to_reference(model), jparams, "params", 1e-6)
    _close_trees(mp.named_to_reference(state["m"]), jstate["m"], "m", 1e-6)
    _close_trees(mp.named_to_reference(state["v"]), jstate["v"], "v", 1e-6)
    # decay made a difference the tolerance sees: a unit's a_param moved
    # by its decay, which a tail's a_param did not get
    start = mp.flatten_tree(tree)
    after = mp.flatten_tree(mp.to_reference(model))
    assert np.abs(after["units/b0/mixer/a_param"]
                  - start["units/b0/mixer/a_param"]).max() > 1e-3


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,))]
    for max_norm in (0.5, 100.0):
        want, jnorm = jopt.clip_by_global_norm([jnp.asarray(g) for g in gs],
                                               max_norm)
        got = [torch.from_numpy(g.copy()) for g in gs]
        norm = optimizer.clip_by_global_norm(got, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ----------------------------------------------------------- compression
def test_compression_matches_reference():
    """int8 error feedback: q and the residual byte-identical, the scale
    equal (the same float32 operations; torch.round and jnp.round both
    round half to even)."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    g[0, :4] = [0.5, 1.5, -2.5, 127.0]     # ties once scaled
    err = (0.01 * rng.standard_normal(g.shape)).astype(np.float32)
    jq, jscale, jres = jcomp.quantize(jnp.asarray(g), jnp.asarray(err))
    q, scale, res = compression.quantize(torch.from_numpy(g),
                                         torch.from_numpy(err))
    assert_same(q, np.asarray(jq), "q")
    assert_same(scale, np.asarray(jscale), "scale")
    assert_same(res, np.asarray(jres), "residual")
    assert_same(compression.dequantize(q, scale),
                np.asarray(jcomp.dequantize(jq, jscale)), "dequantized")


def test_compress_grads_tree_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((9,)).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    jerr = jcomp.init_error_state(jtree)
    flat = {"a": torch.from_numpy(tree["a"]),
            "b.c": torch.from_numpy(tree["b"]["c"])}
    err = compression.init_error_state(flat)
    for _ in range(2):                     # the residual feeds step two
        jout, jerr, jstats = jcomp.compress_grads(jtree, jerr)
        out, err, stats = compression.compress_grads(flat, err)
        assert stats == jstats
        assert_same(out["a"], np.asarray(jout["a"]), "a")
        assert_same(out["b.c"], np.asarray(jout["b"]["c"]), "b/c")
        assert_same(err["b.c"], np.asarray(jerr["b"]["c"]), "err b/c")


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("frames_dim", [None, 16])
def test_token_pipeline_batches_byte_identical(frames_dim):
    want = jdata.TokenPipeline(256, 4, 32, seed=7, frames_dim=frames_dim)
    got = data.TokenPipeline(256, 4, 32, seed=7, frames_dim=frames_dim)
    for i in (0, 1, 5):
        w, g = want.batch_view(i).value(), got.batch_view(i).value()
        assert w.keys() == g.keys()
        for k in w:
            assert_same(g[k], w[k], f"batch {i} {k}")
    assert got.batch_view(3).lineage() == want.batch_view(3).lineage()


def test_markov_lm_and_entropy_floor_match_reference():
    for vocab, branching, seed in ((64, 2, 0), (256, 8, 3)):
        jlm = jdata.MarkovLM(vocab, branching, seed)
        lm = data.MarkovLM(vocab, branching, seed)
        assert_same(lm.next_tokens, jlm.next_tokens, "transitions")
        assert_same(lm.sample(np.random.default_rng(1), 3, 10),
                    jlm.sample(np.random.default_rng(1), 3, 10), "sample")
        assert data.unigram_entropy_floor(lm) \
            == jdata.unigram_entropy_floor(jlm)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("T_shape,chunk,softcap", [((2, 16), 8, 0.0),
                                                   ((3, 7), 8, 0.0),
                                                   ((2, 9), 64, 30.0)])
def test_chunked_cross_entropy_value_and_grads(T_shape, chunk, softcap):
    """Loss sum, token count and the gradients with respect to the head and
    the hidden state against jax.grad of the reference: ragged last chunk,
    ignored labels (-1), softcap. float32, sums in another order: 1e-5."""
    rng = np.random.default_rng(5)
    B, S = T_shape
    D, V = 12, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    y[0, :3] = -1

    def jfn(w, h):
        ls, c = jloss.chunked_cross_entropy(w, h, jnp.asarray(y),
                                            chunk=chunk, softcap=softcap)
        return ls / c, (ls, c)
    (_, (jl, jc)), (jgw, jgh) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(w), jnp.asarray(h))
    tw = torch.from_numpy(w).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    ls, c = loss.chunked_cross_entropy(tw, th, torch.from_numpy(y),
                                       chunk=chunk, softcap=softcap)
    (ls / c).backward()
    assert float(c) == float(jc) == B * S - 3
    np.testing.assert_allclose(float(ls.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------ bf16 backward knob
def test_bf16_backward_scope_grads_close():
    """As the reference's test (tests/test_perf_variants.py): grads of a
    dense layer with and without the scope agree. On the CPU the compute
    dtype is float32 and the scope changes nothing, in both packages, so
    they are equal, and equal to the reference's."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((16, 4))).astype(np.float32)

    def grads(scope):
        tw = torch.from_numpy(w).requires_grad_()
        with layers.bf16_backward_scope(scope):
            (layers.dense(torch.from_numpy(x), tw) ** 2).sum().backward()
        return tw.grad.numpy()
    g0, g1 = grads(False), grads(True)
    np.testing.assert_array_equal(g0, g1)

    def jloss_(x, w):
        return (jlayers.dense(x, w) ** 2).sum()
    with jlayers.bf16_backward_scope(True):
        jg = jax.grad(jloss_, argnums=1)(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(g1, np.asarray(jg), atol=1e-5, rtol=1e-5)


def test_dense_bf16_backward_function():
    """The bf16-backward Function itself (what the scope selects on a
    card), run on bf16 CPU tensors: dw is the float32 sum of exact
    products of the bf16-rounded inputs (so within float32 rounding of the
    float64 sum), dx a bf16 product (one bf16 rounding, 2^-8)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((16, 4)))
                         .astype(np.float32)).requires_grad_()
    xr = x.clone().requires_grad_()
    y = layers.DenseBf16Bwd.apply(xr, w)
    assert y.dtype == torch.bfloat16
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    y.backward(g.to(torch.bfloat16))
    xb = x.to(torch.bfloat16).double().reshape(-1, 16)
    gb = g.to(torch.bfloat16).double().reshape(-1, 4)
    wb = w.detach().to(torch.bfloat16).double()
    assert w.grad.dtype == torch.float32 and xr.grad.dtype == torch.float32
    np.testing.assert_allclose(w.grad.numpy(), (xb.T @ gb).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xr.grad.reshape(-1, 16).numpy(),
                               (gb @ wb.T).numpy(), rtol=2 ** -7, atol=1e-2)


def test_bf16_backward_scope_survives_recompute(monkeypatch, step_setups):
    """With dense computing in bf16 (as on a card; forced here on the CPU)
    the scope's Function must also run when remat recomputes a unit and
    when the loss recomputes a chunk in the backward: else the recomputed
    graph differs from the forward's (on a card torch.utils.checkpoint
    then raises; on the CPU the saved tensors happen to line up). So the
    backward must call the Function's forward once per dense product of
    the units and once per loss chunk. The gradients stay within bf16
    rounding (5e-2 of each gradient's largest magnitude) of the plain bf16
    route's."""
    calls = {"fwd": 0}
    real = layers.DenseBf16Bwd

    class Counting(real):
        @staticmethod
        def forward(ctx, x, w):
            calls["fwd"] += 1
            return real.forward(ctx, x, w)

    monkeypatch.setattr(layers, "compute_dtype",
                        lambda device: torch.bfloat16)
    monkeypatch.setattr(layers, "DenseBf16Bwd", Counting)
    _, cfg, tree, batches = step_setups[RG]
    model = mp.from_reference(tree, cfg, "cpu", trainable=True)
    inputs = torch.from_numpy(batches[0]["inputs"])
    B, S = inputs.shape
    pos = steps.make_positions(B, S)
    with torch.no_grad(), layers.bf16_backward_scope(True):
        x = tf.embed_inputs(model, cfg, inputs, pos)
        for i, kind in enumerate(cfg.pattern):
            x, _, _ = tf.apply_block(model.units[0][f"b{i}"], x, cfg, kind,
                                     pos)
    unit_dense = calls["fwd"]
    chunks = -(-B * S // cfg.loss_chunk)

    def grads(scope):
        model.zero_grad(set_to_none=True)
        with layers.bf16_backward_scope(scope):
            loss = steps.loss_fn(model, cfg, batches[0])[0]
        calls["fwd"] = 0
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}
    want = grads(False)
    assert calls["fwd"] == 0
    got = grads(True)
    assert unit_dense > 0 and \
        calls["fwd"] == cfg.num_units * unit_dense + chunks
    for n, g in want.items():
        scale = float(g.abs().max())
        assert float((got[n] - g).abs().max()) <= 5e-2 * scale, n


# ------------------------------------------------------------ train step
@pytest.fixture(scope="module")
def step_setups():
    """Per arch: the reference config, the port config, the reference's
    initial weights and three batches from the same pipeline."""
    out = {}
    for arch, kw in ((QWEN, {"num_layers": 2}), (RG, {"num_layers": 5})):
        jcfg, cfg = _cfgs(arch, **kw)
        pipe = jdata.TokenPipeline(cfg.vocab_size, 4, 16, seed=1)
        out[arch] = (jcfg, cfg, _ref_tree(jcfg, 10),
                     [pipe.batch_view(i).value() for i in range(3)])
    return out


def _ref_steps(jcfg, tree, batches, oc):
    state = {"params": jax.tree.map(jnp.asarray, tree),
             "opt": jopt.init_opt_state(jax.tree.map(jnp.asarray, tree)),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(jsteps.make_train_step(jcfg, oc))
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_steps(cfg, tree, batches, oc):
    state = steps.state_of(mp.from_reference(tree, cfg, "cpu",
                                             trainable=True))
    fn = steps.make_train_step(cfg, oc)
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("arch", [QWEN, RG])
@pytest.mark.parametrize("n", [1, 3])
def test_train_steps_match_reference(step_setups, arch, n):
    """n train steps from the same weights on the same batches: loss and
    grad_norm within 1e-5 relative, parameters within 2e-5 (float32; the
    reference's associative scan and blocked attention sum in another
    order than the port's plain loops; see OC_STEP)."""
    jcfg, cfg, tree, batches = step_setups[arch]
    ocj, ocp = jopt.OptConfig(**OC_STEP), optimizer.OptConfig(**OC_STEP)
    jstate, jm = _ref_steps(jcfg, tree, batches[:n], ocj)
    state, m = _port_steps(cfg, tree, batches[:n], ocp)
    for got, want in zip(m, jm, strict=True):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    ref_state = steps.state_to_reference(state)
    assert int(ref_state["step"]) == int(jstate["step"]) == n
    _close_trees(ref_state["params"], jax.tree.map(np.asarray,
                                                   jstate["params"]),
                 "params", atol=2e-5)


def test_microbatched_train_step(step_setups):
    """microbatches=2 against the reference's microbatches=2 (1e-5, as
    above), and against the port's microbatches=1, as the reference's own
    test does (tests/test_perf_variants.py:83: losses within 2e-2,
    parameters within 5e-3)."""
    jcfg, cfg, tree, batches = step_setups[QWEN]
    oc = optimizer.OptConfig()
    jcfg2 = dataclasses.replace(jcfg, microbatches=2)
    cfg2 = dataclasses.replace(cfg, microbatches=2)
    jstate, jm = _ref_steps(jcfg2, tree, batches[:1], jopt.OptConfig())
    s2, m2 = _port_steps(cfg2, tree, batches[:1], oc)
    s1, m1 = _port_steps(cfg, tree, batches[:1], oc)
    np.testing.assert_allclose(m2[0]["loss"], jm[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(m2[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-5)
    _close_trees(steps.state_to_reference(s2)["params"],
                 jax.tree.map(np.asarray, jstate["params"]), "mb2",
                 atol=1e-5)
    assert abs(m1[0]["loss"] - m2[0]["loss"]) < 2e-2
    p1 = mp.to_reference(s1["params"])
    p2 = mp.to_reference(s2["params"])
    _close_trees(p1, p2, "mb1 vs mb2", atol=5e-3, rtol=1e-2)


def test_loss_fn_gradients_match_jax_grad(step_setups):
    """Every parameter's gradient of the loss on reduced recurrentgemma-2b
    against jax.grad of the reference's loss_fn, within 1e-5 of the
    largest gradient (float32, other summation orders)."""
    jcfg, cfg, tree, batches = step_setups[RG]
    batch = batches[0]
    (jl, _), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, batch)
    model = mp.from_reference(tree, cfg, "cpu", trainable=True)
    lossv, _ = steps.loss_fn(model, cfg, batch)
    lossv.backward()
    np.testing.assert_allclose(float(lossv.detach()), float(jl), rtol=1e-6)
    grads = mp.named_to_reference({n: p.grad for n, p in
                                   model.named_parameters()})
    top = max(float(np.abs(v).max()) for v in _leaves(jg).values())
    _close_trees(grads, jax.tree.map(np.asarray, jg), "grads",
                 atol=1e-5 * top)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_gradients(step_setups, remat):
    """"full" (the default) against "none" and "dots": remat only changes
    what is kept, so the gradients are equal."""
    _, cfg, tree, batches = step_setups[RG]

    def grads(c):
        model = mp.from_reference(tree, c, "cpu", trainable=True)
        steps.loss_fn(model, c, batches[0])[0].backward()
        return {n: p.grad for n, p in model.named_parameters()}
    want = grads(cfg)
    got = grads(dataclasses.replace(cfg, remat=remat))
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, rtol=0, atol=0, msg=n)


def test_trainable_model_is_float32_with_grad_and_serving_is_frozen():
    _, cfg = _cfgs(RG, num_layers=5)
    train = tf.Transformer(cfg, "meta", trainable=True)
    serve = tf.Transformer(cfg, "meta")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in train.parameters())
    assert not any(p.requires_grad for p in serve.parameters())


# ---------------------------------------------------- driver, checkpoints
def _tiny_qwen():
    return reduced(get_config(QWEN), num_layers=1, d_model=32, vocab_size=64,
                   head_dim=8, d_ff=64, loss_chunk=32)


def test_train_driver_failure_recovery(tmp_path):
    """As tests/test_train.py's driver test, and the losses after recovery
    equal an uninterrupted run's (the CPU path is deterministic: 1e-6)."""
    cfg = _tiny_qwen()
    losses, state = ptrain.run(cfg, steps=12, batch=2, seq=16,
                               ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
                               fail_at=8, log_every=100, device="cpu")
    assert int(state["step"]) == 12
    assert len(losses) == 12
    clean, _ = ptrain.run(cfg, steps=12, batch=2, seq=16,
                          ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                          log_every=100, device="cpu")
    for i in range(12):
        np.testing.assert_allclose(losses[i], clean[i], rtol=1e-6)


def test_train_driver_compress_runs(tmp_path):
    cfg = _tiny_qwen()
    losses, state = ptrain.run(cfg, steps=4, batch=2, seq=16,
                               ckpt_dir=None, compress=True, log_every=100,
                               device="cpu")
    assert int(state["step"]) == 4
    assert all(np.isfinite(v) for v in losses.values())


def test_train_main_cpu_loss_falls(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --steps 50``:
    reduced qwen2.5-14b, and main's own assertion that the loss fell; run
    twice, each run in a new checkpoint directory of its own."""
    monkeypatch.setattr(ptrain, "CKPT_ROOT", tmp_path)
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu",
                                      "--steps", "50"])
    ptrain.main()
    ptrain.main()
    assert len(list(tmp_path.iterdir())) == 2


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A port train state after two steps, saved by the port, restored by
    the reference's CheckpointManager into its own train state: every leaf
    equal."""
    jcfg, cfg = _cfgs(RG, num_layers=5)
    tree = _ref_tree(jcfg, 3)
    state, _ = _port_steps(cfg, tree, [
        jdata.TokenPipeline(cfg.vocab_size, 2, 8, seed=2).batch_view(i)
        .value() for i in range(2)], optimizer.OptConfig(**OC_STEP))
    CheckpointManager(tmp_path).save(steps.state_to_reference(state),
                                     epoch=0, step=2)
    like = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    restored = JCkpt(tmp_path).restore(like)
    want = steps.state_to_reference(state)
    assert _leaves(restored).keys() == _leaves(want).keys()
    for k, v in _leaves(want).items():
        assert_same(_leaves(restored)[k], v, str(k))


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reference's train state after one step, saved by the reference,
    restored into a port train state: every leaf equal, and one more step
    on each side still agrees."""
    jcfg, cfg = _cfgs(QWEN, num_layers=2)
    tree = _ref_tree(jcfg, 4)
    pipe = jdata.TokenPipeline(cfg.vocab_size, 2, 16, seed=5)
    b0, b1 = pipe.batch_view(0).value(), pipe.batch_view(1).value()
    oc = jopt.OptConfig(**OC_STEP)
    jstate, _ = _ref_steps(jcfg, tree, [b0], oc)
    JCkpt(tmp_path).save(jstate, epoch=0, step=1)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    steps.load_state(state, CheckpointManager(tmp_path).restore(
        steps.reference_state_like(cfg)))
    got = steps.state_to_reference(state)
    for k, v in _leaves(jax.tree.map(np.asarray, jstate)).items():
        assert_same(_leaves(got)[k], v, str(k))
    jstate2, jm = jax.jit(jsteps.make_train_step(jcfg, oc))(jstate, b1)
    state, m = steps.make_train_step(cfg, optimizer.OptConfig(**OC_STEP))(
        state, b1)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)


# ------------------------------------------------- chip_smoke.py phase 8
def test_chip_smoke_training_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phase 8b, 8c and 8d on the CPU at the reduced size,
    with the plain versions standing in for the raw launchers on the
    kernel route (so the autograd Functions run): the two routes' gradients
    agree, the planted backward faults exceed the limit, the
    driver trains, and the fault path recovers and serves its
    checkpoint."""
    import importlib.util
    import pathlib

    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import lru_scan as cuda_lru
    from repro_torch.kernels import ops, ref

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def fwd(q, k, v, *, causal=True, window=None, return_lse=False):
        out = ref.flash_attention(q, k, v, causal=causal, window=window)
        if not return_lse:
            return out
        return out, torch.zeros(q.shape[:3])     # the stand-in ignores it

    def bwd(q, k, v, out, dout, lse, *, causal=True, window=None):
        return ref.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       window=window)

    def scan_bwd(a, h, dh, h0=None, *, want_dh0=False):
        da, db, dh0 = ref.lru_scan_bwd(a, h, dh, h0)
        return da, db, dh0 if want_dh0 else None

    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(cuda_fa, "flash_attention", fwd)
    monkeypatch.setattr(cuda_fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(cuda_lru, "lru_scan", ref.lru_scan)
    monkeypatch.setattr(cuda_lru, "lru_scan_bwd", scan_bwd)
    cfg = reduced(get_config(RG))
    grads = cs.check_training_gradients(torch, cfg, "cpu", batch=2, seq=16)
    # the plain backward against autograd of the plain forward: float32
    # rounding of two formulas
    assert grads["layers"] == 3 and grads["worst_rel_err"] < 1e-5
    assert all(e > cs.GRAD_RTOL for e in grads["planted"].values())
    run = cs.train_model(torch, reduced(cfg, num_layers=5), "cpu", batch=2,
                         seq=16)
    assert len(run["losses"]) == cs.TRAIN_WARMUP + cs.TRAIN_STEPS
    assert cs.launches_per_step(reduced(cfg, num_layers=5)) == {
        "lru_scan": 6, "lru_scan_bwd": 4, "flash_attention": 2,
        "flash_attention_bwd": 1}
    assert cs.launches_per_step(get_config(RG)) == {
        "lru_scan": 34, "lru_scan_bwd": 18, "flash_attention": 16,
        "flash_attention_bwd": 8}
    fault = cs.train_fault_path(torch, cfg, "cpu")
    assert fault["fail_at_rel_diff"] <= 1e-6
    assert len(fault["served"]) == 2
