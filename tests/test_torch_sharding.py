"""The port's meshes and sharding rules against the JAX package's.

The rules depend only on the mesh's axis sizes, so the reference gets a
stand-in mesh (``axis_names`` and a NumPy ``devices`` array of the
production shape, test code only) and both packages derive the specs of
every parameter and decode cache of the ten architectures at full size
(shapes only: nothing is allocated, nothing is compiled). Specs must be
equal entry for entry. The per-device shard shapes are held against
``NamedSharding.shard_shape`` on a real 4-device host mesh in a
subprocess.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import all_configs as ref_configs  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import SHAPES, all_configs  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from _torch_parity import reference_archs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's ten (the port's own architectures have no reference
# shardings to hold them to)
ARCHS = reference_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


class _StandInMesh:
    """What the reference's ShardingRules reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _mappings(cfg, multi_pod):
    for long_context in (False, True):
        for serve in (False, True):
            yield (long_context, serve), jshd.baseline_mapping(
                multi_pod, long_context=long_context, serve=serve,
                expert_sharding=cfg.expert_sharding), shd.baseline_mapping(
                multi_pod, long_context=long_context, serve=serve,
                expert_sharding=cfg.expert_sharding)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _ref_flat(tree):
    import jax
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _assert_same_specs(ref_tree, port_tree, where):
    ref, port = _ref_flat(ref_tree), _flat(port_tree)
    assert set(ref) == set(port), where
    for k, want in ref.items():
        got = port[k]
        assert isinstance(got, shd.PartitionSpec)
        assert tuple(got) == tuple(want), (where, k, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_at_full_size(arch):
    """Every parameter's spec on the (16, 16), (2, 16, 16) and (1, 1)
    meshes under every baseline mapping (long context, serving, the
    config's expert sharding) equals the reference's."""
    cfg, rcfg = all_configs()[arch], ref_configs()[arch]
    ref_shapes = jtf.param_shapes(rcfg)
    port_shapes = specs.param_shapes(cfg, trainable=True)
    for name, (shape, names) in MESHES.items():
        multi = len(shape) == 3
        for variant, jmap, pmap in _mappings(cfg, multi):
            want = jshd.param_specs(
                ref_shapes, jshd.ShardingRules(_StandInMesh(shape, names),
                                               jmap))
            got = shd.param_specs(port_shapes, shd.ShardingRules(
                pmesh.Mesh(names, shape), pmap))
            _assert_same_specs(want, got, (arch, name, variant))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference_at_full_size(arch):
    """The decode caches of decode_32k and long_500k (the GQA head-dim
    fallback included) get the reference's specs on every mesh and
    mapping."""
    cfg, rcfg = all_configs()[arch], ref_configs()[arch]
    for cell in ("decode_32k", "long_500k"):
        B, S = SHAPES[cell].global_batch, SHAPES[cell].seq_len
        ref_cache = jtf.cache_shapes(rcfg, B, S)
        port_cache = specs.cache_shapes(cfg, B, S)
        for name, (shape, names) in MESHES.items():
            multi = len(shape) == 3
            for variant, jmap, pmap in _mappings(cfg, multi):
                want = jshd.cache_specs(ref_cache, jshd.ShardingRules(
                    _StandInMesh(shape, names), jmap))
                got = shd.cache_specs(port_cache, shd.ShardingRules(
                    pmesh.Mesh(names, shape), pmap))
                _assert_same_specs(want, got, (arch, cell, name, variant))


def test_rules_spec_replicates_uneven_dims_as_the_reference():
    mesh = pmesh.make_production_mesh()
    rules = shd.ShardingRules(mesh, shd.baseline_mapping(False))
    jrules = jshd.ShardingRules(_StandInMesh((16, 16), ("data", "model")),
                                jshd.baseline_mapping(False))
    for axes, dims in ((("batch", "seq", "ff"), (32, 4096, 7680)),
                       (("batch", "seq", "ff"), (8, 4096, 100)),
                       (("vocab", "dmodel_w"), (256000, 2560)),
                       (("kv_heads", "head_dim"), (1, 256))):
        assert tuple(rules.spec(axes, dims)) == tuple(jrules.spec(axes,
                                                                 dims))
    assert shd.shard_shape((32, 4096, 7680), rules.spec(
        ("batch", "seq", "ff"), (32, 4096, 7680)), rules) == (2, 4096, 480)
    multi = shd.ShardingRules(pmesh.make_production_mesh(multi_pod=True),
                              shd.baseline_mapping(True))
    spec = multi.spec(("batch", None), (64, 3))
    assert tuple(spec) == (("pod", "data"), None)
    assert shd.shard_shape((64, 3), spec, multi) == (2, 3)


def test_constrain_is_the_identity_on_one_card():
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.constrain(x, ("batch", "dmodel")) is x
    rules = shd.ShardingRules(pmesh.make_production_mesh(),
                              shd.baseline_mapping(False))
    with rules.active():
        assert shd.constrain(x, ("batch", "dmodel")) is x
        assert shd._current() is rules
    assert shd._current() is None


def test_meshes_declared_and_local():
    single = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.devices) == (
        ("data", "model"), (16, 16), ())
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    local = pmesh.make_local_mesh("cpu")
    assert local.shape == (1, 1) and local.devices == (torch.device("cpu"),)
    assert pmesh.one_card_mesh().shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_local_mesh("cuda")
    with pytest.raises(ValueError):
        pmesh.Mesh(("data",), (2, 2))


_SHARD_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import all_configs, reduced
from repro.launch import sharding as jshd
from repro.models import transformer as jtf
from repro_torch.configs import all_configs as pconfigs, reduced as preduced
from repro_torch.launch import mesh as pmesh, sharding as shd, specs

mesh = jax.make_mesh((2, 2), ("data", "model"))
pm = pmesh.Mesh(("data", "model"), (2, 2))
bad, n = [], 0
for arch in sorted(all_configs()):
    rcfg, cfg = reduced(all_configs()[arch]), preduced(pconfigs()[arch])
    for kind in ("params", "cache"):
        if kind == "params":
            ref_tree = jtf.param_shapes(rcfg)
            port_tree = specs.param_shapes(cfg, trainable=True)
        else:
            ref_tree = jtf.cache_shapes(rcfg, 4, 32)
            port_tree = specs.cache_shapes(cfg, 4, 32)
        jrules = jshd.ShardingRules(mesh, jshd.baseline_mapping(
            False, expert_sharding=rcfg.expert_sharding))
        prules = shd.ShardingRules(pm, shd.baseline_mapping(
            False, expert_sharding=cfg.expert_sharding))
        jspecs = (jshd.param_specs if kind == "params"
                  else jshd.cache_specs)(ref_tree, jrules)
        pspecs = (shd.param_specs if kind == "params"
                  else shd.cache_specs)(port_tree, prules)
        flat = {"/".join(k.key for k in p): (leaf, s) for (p, leaf), s in zip(
            jax.tree_util.tree_flatten_with_path(ref_tree)[0],
            jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))}
        def walk(t, s, pre=()):
            if isinstance(t, dict):
                for k in t:
                    yield from walk(t[k], s[k], pre + (k,))
            else:
                yield "/".join(pre), t, s
        for path, leaf, spec in walk(port_tree, pspecs):
            rleaf, rspec = flat[path]
            want = NamedSharding(mesh, rspec).shard_shape(rleaf.shape)
            got = shd.shard_shape(tuple(leaf.shape), spec, prules)
            n += 1
            if tuple(want) != tuple(got):
                bad.append([arch, kind, path, list(want), list(got)])
print(json.dumps({"n": n, "bad": bad}))
"""


def test_shard_shapes_match_named_sharding_on_four_devices():
    """On a (2, 2) mesh of 4 host devices, the reference's
    ``NamedSharding(mesh, spec).shard_shape`` of every parameter and cache
    leaf of the reduced configs equals the port's per-device shape."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _SHARD_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n"] > 100 and not out["bad"], out["bad"][:5]
