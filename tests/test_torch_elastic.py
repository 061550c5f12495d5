"""The port's elastic restart against the JAX package's.

Checkpoints hold the reference's train-state tree, so a checkpoint that
either package's ``CheckpointManager`` writes is restored by the other's
``elastic_restart`` equal leaf by leaf (float32 copied, never rounded).
A reduced recurrentgemma-2b continued after a restart gives the
uninterrupted run's losses exactly, the rehearsal of ``chip_smoke.py``
phase 12a on the host.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.versioned import Version  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models.params import flatten_tree  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"


def _ref_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_state_equals_tree(state, tree):
    """The port ``state``'s reference tree equals ``tree`` leaf by leaf,
    bits and dtypes."""
    got = flatten_tree(steps.state_to_reference(state))
    want = _ref_flat(tree)
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference saves its train state at step 3 (moments made nonzero
    by one of its own steps); the port's elastic_restart onto the CPU
    gives a state equal leaf by leaf, at step 3."""
    rcfg = ref_reduced(ref_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    state = jsteps.init_train_state(rcfg, jax.random.PRNGKey(0))
    from repro.train.data import TokenPipeline
    batch = TokenPipeline(rcfg.vocab_size, 2, 16, seed=0).batch_view(0) \
        .value()
    state, _ = jax.jit(jsteps.make_train_step(rcfg))(state, batch)
    state = dict(state, step=jnp.asarray(3, jnp.int32))
    JCkpt(tmp_path).save(state, epoch=0, step=3)
    got = elastic.elastic_restart(cfg, CheckpointManager(tmp_path),
                                  steps.reference_state_like(cfg),
                                  pmesh.make_local_mesh("cpu"))
    assert int(got["step"]) == 3 and int(got["opt"]["count"]) == 1
    assert got["params"].lm_head.device.type == "cpu"
    assert all(p.requires_grad for p in got["params"].parameters())
    _assert_state_equals_tree(got, state)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port's driver checkpoints at step 3; the reference's
    elastic_restart on a (1, 1) mesh gives its tree leaf by leaf, and the
    port's own restore of the same snapshot agrees."""
    rcfg = ref_reduced(ref_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    _, state = ptrain.run(cfg, steps=4, batch=2, seq=16, ckpt_dir=tmp_path,
                          ckpt_every=2, log_every=100, device="cpu")
    like = jsteps.init_train_state(rcfg, jax.random.PRNGKey(1))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = jelastic.elastic_restart(rcfg, JCkpt(tmp_path), like, mesh,
                                   version=Version(0, 3))
    assert int(ref["step"]) == 3
    ours = elastic.elastic_restart(cfg, CheckpointManager(tmp_path),
                                   steps.reference_state_like(cfg),
                                   pmesh.make_local_mesh("cpu"),
                                   version=Version(0, 3))
    _assert_state_equals_tree(ours, jax.tree.map(np.asarray, ref))


def test_plan_resharding_matches_the_reference_specs():
    """plan_resharding gives each parameter the reference's spec on the
    production meshes and a (1, 1) mesh; shard shapes divide by the axes'
    sizes; reshard refuses a placement that splits a leaf, and a declared
    mesh that has no device."""
    rcfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    from repro.launch import sharding as jshd
    from repro.models import transformer as jtf
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs

    params = specs.param_shapes(cfg, trainable=True)
    ref_params = jtf.param_shapes(rcfg)
    for multi in (False, True):
        mesh = pmesh.make_production_mesh(multi_pod=multi)
        plan = elastic.plan_resharding(cfg, params, None, mesh,
                                       multi_pod_new=multi)

        class StandIn:
            axis_names = mesh.axis_names
            devices = np.empty(mesh.shape, dtype=object)
        want = jax.tree_util.tree_flatten_with_path(
            jshd.param_specs(ref_params, jshd.ShardingRules(
                StandIn, jshd.baseline_mapping(
                    multi, expert_sharding=rcfg.expert_sharding))),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = {"/".join(k.key for k in path): spec for path, spec in want}
        flat = flatten_tree(plan)
        assert set(flat) == set(want)
        for k, p in flat.items():
            assert tuple(p.spec) == tuple(want[k]), k
            assert p.device is None
        emb = flat["embed"]
        assert emb.shard_shape == (256000 // 16, 2560 // 16)
        with pytest.raises(ValueError, match="whole"):
            elastic.reshard({"embed": np.zeros((256000, 2560), np.float32)},
                            {"embed": emb})
    one = elastic.plan_resharding(cfg, params, None,
                                  pmesh.make_local_mesh("cpu"))
    assert flatten_tree(one)["embed"].shard_shape == (256000, 2560)
    moved = elastic.reshard({"a": np.arange(4, dtype=np.float32)},
                            {"a": elastic.Placement(shd.P(None),
                                                    torch.device("cpu"),
                                                    (4,))})
    assert torch.equal(moved["a"], torch.arange(4.0))
    with pytest.raises(ValueError, match="declared"):
        elastic.reshard({"a": np.zeros(4)},
                        {"a": elastic.Placement(shd.P(None), None, (4,))})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_elastic_continuation_rehearses_on_cpu():
    """Phase 12a on the host: a reduced recurrentgemma-2b (one unit)
    trains 2 steps with a checkpoint, the CPU restore is bit-equal to the
    state at the checkpoint, and 2 steps after the restart give the
    uninterrupted run's losses exactly at batch indices 2 and 3."""
    cs = _chip_smoke()
    cfg = reduced(get_config(ARCH), num_layers=3)
    out = cs.elastic_continuation(torch, cfg, "cpu", batch=2, seq=32)
    assert out["resumed"] == out["uninterrupted"]
    assert len(out["resumed"]) == 2 and out["ckpt_bytes"] > 0
    assert out["launches"] == {k: 0 for k in out["launches"]}


def test_continuation_continues_the_batch_index(tmp_path):
    """continue_training picks up at the state's step: batch indices
    from the restored step on, each loss equal to the uninterrupted
    driver run's at that index."""
    cfg = reduced(get_config(ARCH))
    clean, _ = ptrain.run(cfg, steps=5, batch=2, seq=16, ckpt_dir=tmp_path,
                          ckpt_every=2, log_every=100, device="cpu")
    state = elastic.elastic_restart(cfg, CheckpointManager(tmp_path),
                                    steps.reference_state_like(cfg),
                                    pmesh.make_local_mesh("cpu"),
                                    version=Version(0, 3))
    losses = elastic.continue_training(cfg, state, steps_n=2, batch=2,
                                       seq=16)
    assert list(losses) == [3, 4]
    assert losses == {3: clean[3], 4: clean[4]}
    assert int(state["step"]) == 5


def test_chip_smoke_state_comparison_catches_one_changed_bit():
    """Phase 12a's comparison of a restored state with the copy taken at
    the checkpoint: equal states pass; one bit of one moment, or the
    step, changed is named."""
    cs = _chip_smoke()
    cfg = reduced(get_config(ARCH))
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    copy = cs.host_copy(state)
    assert cs.state_mismatches(torch, state, copy) == []
    m = state["opt"]["m"]["lm_head"]
    m.view(torch.int32)[0, 0] ^= 1
    state["step"] = state["step"] + 1
    bad = cs.state_mismatches(torch, state, copy)
    assert bad == ["m:lm_head", "step 1 != 0"]
