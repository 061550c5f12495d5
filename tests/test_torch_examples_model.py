"""The port's model demos against the JAX package's examples, on the CPU,
and the CPU rehearsal of ``chip_smoke.py`` phase 14.

``examples/torch_serve_batched.py`` and ``examples/torch_quickstart.py``
serve the reference's weights, carried across with
``models.params.from_reference``, to the reference's greedy tokens (the
port draws its own random weights from ``torch.Generator``, whose bits
differ from ``jax.random``'s); ``examples/torch_elastic_restart.py``
restores a checkpoint the reference's ``launch.train.run`` wrote and
resumes with the reference's losses, within the training tolerance of
``tests/test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from _torch_parity import (assert_config_same, load_chip_smoke,  # noqa: E402,F401,E501
                           one_torch_thread)

from repro.configs import all_configs as ref_configs  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.serve import Server as RServer  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.train.data import TokenPipeline as RPipe  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402

# tests/test_torch_train.py's tolerance for losses after the same steps
LOSS_RTOL = 1e-5


def _host_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mixtral-8x22b",
                                  "recurrentgemma-2b", "xlstm-1.3b"])
def test_serve_batched_tokens_equal_the_reference(arch):
    """Each model of the batched serving demo, reduced, with the
    reference's ``init_params(cfg, PRNGKey(0))`` weights carried across:
    the port's ``serve`` gives the reference ``Server.generate``'s greedy
    tokens on the demo's 4 requests of 16 tokens (NumPy seed 1), 8 new."""
    demo = load_chip_smoke().load_demo("torch_serve_batched")
    b = demo.Batch()
    rcfg = ref_reduced(ref_configs()[arch])
    params = jtf.init_params(rcfg, jax.random.PRNGKey(b.init_seed))
    prompts = np.random.default_rng(b.prompt_seed).integers(
        0, rcfg.vocab_size, (b.requests, b.prompt)).astype(np.int32)
    want = np.asarray(RServer(rcfg, params).generate(prompts, b.gen))
    cfg = demo.reduced(demo.all_configs()[arch])
    assert np.array_equal(demo.prompts_for(cfg, b), prompts)
    got = demo.serve(cfg, mp.from_reference(_host_tree(params), cfg, "cpu"),
                     b)
    assert got["arch"] == arch
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want)


def test_quickstart_serves_the_reference_trained_weights(tmp_path):
    """The reference's quickstart trains (20 of the demo's 60 steps, to
    keep the test short); its float32 params, carried across as the
    port's trainable module and served uncast by the port demo's
    ``serve``, give the reference ``Server``'s 8 greedy tokens on the
    demo's 2 prompts."""
    demo = load_chip_smoke().load_demo("torch_quickstart")
    q = demo.Quick()
    rcfg = ref_reduced(ref_configs()["qwen2.5-14b"], num_layers=2,
                       d_model=128, vocab_size=128, loss_chunk=512)
    cfg = demo.config()
    assert_config_same(cfg, rcfg)
    _, state = jtrain.run(rcfg, steps=20, batch=q.batch, seq=q.seq,
                          ckpt_dir=str(tmp_path), ckpt_every=q.ckpt_every,
                          log_every=q.log_every)
    prompts = demo.prompts_for(cfg, q)
    want = np.asarray(RServer(rcfg, state["params"]).generate(prompts, q.gen))
    model = mp.from_reference(_host_tree(state["params"]), cfg, "cpu",
                              trainable=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_array_equal(demo.serve(cfg, model, q), want)


def test_elastic_restart_resumes_from_the_reference_checkpoint(tmp_path):
    """The reference's ``launch.train.run`` trains with int8 compression
    (3 of the demo's 25 steps, checkpoint every 2, to keep the test short)
    and checkpoints at step 3 (after batch index 2); the port demo's restart
    restores it onto a (1, 1) mesh on the CPU and resumes 5 steps whose
    losses are the reference's own restart's (its elastic_restart on a
    (1, 1) mesh, then its jitted train step) within the training
    tolerance."""
    demo = load_chip_smoke().load_demo("torch_elastic_restart")
    e = dataclasses.replace(demo.Elastic(), steps=3, ckpt_every=2)
    rcfg = ref_reduced(ref_configs()["qwen2.5-14b"], num_layers=2)
    assert_config_same(demo.config(), rcfg)
    _, state = jtrain.run(rcfg, steps=e.steps, batch=e.batch, seq=e.seq,
                          ckpt_dir=str(tmp_path), ckpt_every=e.ckpt_every,
                          compress=True, log_every=e.log_every)
    got = demo.restart_and_resume(e, "cpu", str(tmp_path))
    assert got["restored"] == 3 and got["final_step"] == 3 + e.resume
    assert got["mesh"] == {"data": 1, "model": 1}
    assert got["mesh_device"] == "cpu"
    # the reference's own restart; JAX 0.9.0's default Explicit mesh axes
    # fail its gather (a reference quirk), so the axes are Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rstate = jelastic.elastic_restart(rcfg, JCkpt(str(tmp_path)), state, mesh)
    step_fn = jax.jit(jsteps.make_train_step(rcfg))
    pipe = RPipe(rcfg.vocab_size, e.batch, e.seq, seed=0)
    want = []
    for j in range(int(rstate["step"]), int(rstate["step"]) + e.resume):
        rstate, metrics = step_fn(rstate, pipe.batch_view(j).value())
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got["resumed"], want, rtol=LOSS_RTOL)


# ------------------------------------------------ chip_smoke.py phase 14
def test_chip_smoke_phase14_rehearses_on_cpu():
    """Phase 14 of chip_smoke.py on the CPU: 14a and 14b at DEMO_SMALL
    (the end-to-end demo's facts equal to the CPU path's, its PageRank
    runs and the live demo's within PLANE_PAGERANK_RTOL of float64 and
    the bf16 controls over it, the top-10 against float64's; every live
    and RPC answer audited), 14c's subprocess, 14d's three reduced
    models against the plain route, 14e's training demos (the first
    loss, the fall, the restart at the newest checkpoint's step and its
    first resumed loss equal to the uninterrupted run's)."""
    cs = load_chip_smoke()
    out = cs.run_demos(torch, None, "cpu rehearsal", device="cpu",
                       small=True)
    a, b, c, d, e = (out[k] for k in ("14a", "14b", "14c", "14d", "14e"))
    assert a["size"]["vertices"] == cs.DEMO_SMALL["vertices"]
    assert a["facts"]["straggler_frontier"] == -1
    assert a["pagerank"]["kernel"] <= cs.PLANE_PAGERANK_RTOL \
        < a["pagerank"]["bf16_control"]
    assert b["pagerank"]["kernel"] <= cs.PLANE_PAGERANK_RTOL \
        < b["pagerank"]["bf16_control"]
    assert all(b["audited"][k] > 0 for k in cs.QUERY_KINDS)
    assert c["pinned"] == 4 and sum(c["audited"].values()) == 48
    assert sorted(d["models"]) == ["mixtral-8x22b", "recurrentgemma-2b",
                                   "xlstm-1.3b"]
    assert all(m["prefill_rel_err"] <= cs.MODEL_RTOL
               for m in d["models"].values())
    assert e["elastic"]["restored"] == 21 and e["elastic"]["final_step"] == 26
    assert len(e["quickstart"]["generated"]) == 8


def test_chip_smoke_default_model_checks_rehearse_on_cpu(monkeypatch):
    """14d's checks of the default model (phase 9's serve_family) on the
    CPU at the reduced size, the plain version standing in for the CUDA
    kernel on the kernel route: it serves, every attention call is
    tallied, no mixer differs beyond MIXER_RTOL nor the prefill (nor the
    sound route) beyond one bf16 step a layer, compounding, and both
    planted faults exceed their limits."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops, ref

    cs = load_chip_smoke()
    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda q, k, v, *, causal, window: ref.flash_attention(
                            q, k, v, causal=causal, window=window))
    cfg = reduced(get_config(cs.DEFAULT_ARCH))
    run = cs.serve_model(torch, cfg, "cpu", requests=2, prompt=16, gen=3)
    assert run["out"].shape == (2, 3)
    assert sum(run["shapes"].values()) == cfg.num_layers
    layers_ = cs.check_layers_against_plain(torch, run)
    assert layers_["worst"]["out"] <= cs.MIXER_RTOL
    assert sorted(layers_["planted"]) == ["layer0 causal off",
                                          "layer0 kv heads rolled"]
    agree = cs.check_model_against_plain(
        torch, run, gen=3, rtol=(1 + 2.0 ** -8) ** cfg.num_layers - 1,
        faults=cs.attention_faults(cfg, "attn"),
        sound={"P to 8 bits": cs.rounded_p_attention(
            torch, cs.SOUND_P_BITS, block=8)})
    assert agree["worst_rel_err"] <= agree["limit"]
    assert min(agree["planted"].values()) > agree["limit"]


def test_chip_smoke_top10_swaps_hold_only_ties():
    """14a's top-10 check: a swap of two ranks within the limit passes
    and is reported; one over it fails."""
    cs = load_chip_smoke()
    exact = np.linspace(1.0, 0.5, 20)
    exact[3] = exact[4] * (1 + cs.PLANE_PAGERANK_RTOL / 2)
    top = list(range(10))
    assert cs.top10_swaps(np, top, exact, cs.PLANE_PAGERANK_RTOL) == []
    top[3], top[4] = 4, 3
    swaps = cs.top10_swaps(np, top, exact, cs.PLANE_PAGERANK_RTOL)
    assert [s[:2] for s in swaps] == [[4, 3], [3, 4]]
    top[5], top[6] = 6, 5
    with pytest.raises(cs.SmokeFailure, match="swapped ranks"):
        cs.top10_swaps(np, top, exact, cs.PLANE_PAGERANK_RTOL)


def test_chip_smoke_default_model_at_full_width():
    """14d's full-width run: the default model's FAMILY_RUNS entry (the
    last; phase 9 runs the others) makes 48 attention calls at (4, 40, 8,
    4096, 128) without a window, and has a prefill limit."""
    cs = load_chip_smoke()
    assert cs.FAMILY_RUNS[-1] == (cs.DEFAULT_ARCH, None, 4)
    assert cs.DEFAULT_ARCH not in {a for a, _, _ in cs.PHASE9_RUNS}
    cfg = cs.family_config(cs.DEFAULT_ARCH, None)
    assert cs.family_attention_shapes(cfg, 4) == {
        (4, 40, 8, cs.FAMILY_PROMPT, 128, None): 48}
    assert cfg.n_heads // cfg.n_kv_heads == 5 and cfg.qkv_bias
    assert 0 < cs.FAMILY_PREFILL_RTOL[cs.DEFAULT_ARCH] < 1


def test_chip_smoke_phase14e_holds_the_training_shapes():
    """14e holds the attention kernels against their plain versions at
    the shapes the training demos launch them at: the quickstart's
    (16, 4, 2, 64, 16) and the elastic restart's (8, 4, 2, 32, 16), in
    bf16, without a window, once a layer."""
    cs = load_chip_smoke()
    for stem, run, shape in (
            ("torch_quickstart", "Quick", (16, 4, 2, 64, 16, None)),
            ("torch_elastic_restart", "Elastic", (8, 4, 2, 32, 16, None))):
        demo = cs.load_demo(stem)
        cfg, r = demo.config(), getattr(demo, run)()
        assert cfg.dtype == "bfloat16"
        assert cs.family_attention_shapes(cfg, r.batch, prompt=r.seq) == {
            shape: cfg.num_layers}
