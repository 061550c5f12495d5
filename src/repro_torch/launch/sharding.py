"""Logical-axis sharding rules and the specs derived from them; the port of
``repro/launch/sharding.py``.

The rule tables are the reference's, entry for entry: a
:class:`ShardingRules` maps logical axis names to mesh axes, ``param_specs``
derives each parameter's :class:`PartitionSpec` from its path in the
reference's parameter tree (units stacked on a leading axis, as
``models.params.reference_shapes`` and ``launch.specs.param_shapes`` give
it), and ``cache_specs`` does the same for decode caches, with the
reference's GQA fallback. A spec is the port's own ``PartitionSpec``, a
tuple whose entries (None, an axis name, or a tuple of axis names) compare
element by element with JAX's.

On one card there is nothing to constrain: :func:`constrain` returns its
input. The rules serve the dry-run (per-device shard shapes on the
reference's meshes, :func:`shard_shape`) and the elastic restart's plan.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of axis names (sharded over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _current() -> Optional["ShardingRules"]:
    return getattr(_STATE, "rules", None)


def _prod(it) -> int:
    r = 1
    for v in it:
        r *= v
    return r


class ShardingRules:
    """Maps logical axis names -> mesh axis (or None = replicate)."""

    def __init__(self, mesh, mapping):
        self.mesh = mesh
        self.mapping = dict(mapping)
        self.axis_sizes = dict(zip(mesh.axis_names, mesh.shape, strict=True))

    def axis_size(self, axis) -> int:
        """Devices along ``axis``: an axis name, a tuple of them, or None."""
        if axis is None:
            return 1
        if isinstance(axis, str):
            return self.axis_sizes[axis]
        return _prod(self.axis_sizes[a] for a in axis)

    def spec(self, logical_axes, dims=None) -> PartitionSpec:
        """Resolve logical axes to a PartitionSpec, dropping non-divisible
        or unmapped axes (replica-coherence fallback: replicate)."""
        out = []
        for i, name in enumerate(logical_axes):
            axis = self.mapping.get(name)
            if axis is None:
                out.append(None)
                continue
            if dims is not None and dims[i] % self.axis_size(axis) != 0:
                out.append(None)  # uneven -> replicate this dim
            else:
                out.append(axis)
        return PartitionSpec(*out)

    @contextlib.contextmanager
    def active(self):
        prev = _current()
        _STATE.rules = self
        try:
            yield self
        finally:
            _STATE.rules = prev


def constrain(x, logical_axes):
    """The reference's sharding hint. One card holds every tensor whole,
    so ``x`` comes back unchanged, with or without rules active."""
    return x


def shard_shape(shape, spec: PartitionSpec, rules: ShardingRules) -> tuple:
    """The per-device shape of a leaf of ``shape`` laid out by ``spec``
    (each sharded dimension divided by its axes' size; the rules never
    shard an uneven dimension)."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // rules.axis_size(a) for d, a in zip(shape, parts))


# --------------------------------------------------------------------------
# Baseline logical->mesh mappings (the "paper-faithful" starting point):
# DP/FSDP over `data` (and `pod` for batch), Megatron TP over `model`.
# --------------------------------------------------------------------------
def baseline_mapping(multi_pod: bool, *, long_context: bool = False,
                     serve: bool = False, expert_sharding: str = "tensor"):
    batch_axes = ("pod", "data") if multi_pod else "data"
    m = {
        "batch": batch_axes,
        "seq": None,
        "dmodel": None,
        "dmodel_w": "data",      # FSDP shard of weight d_model dims
        "ff": "model",
        "qdim": "model",
        "kvdim": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        # MoE: EP over the model axis when E % model == 0 (phi3.5), else TP
        # inside each expert's ffn dims (mixtral).
        "expert": "model" if expert_sharding == "expert" else None,
        "ff_exp": None if expert_sharding == "expert" else "model",
        "lru": "model",
        "inner": "model",        # mLSTM/sLSTM inner projection dim
        "cache_seq": None,
        "cache_batch": batch_axes,
    }
    if long_context:
        # batch=1: context/sequence parallelism over the data axis instead.
        m["cache_batch"] = None
        m["cache_seq"] = "data"
        m["seq"] = "data"
    # serve: no optimizer state; the weights keep the same TP + FSDP
    # layout as in training (the reference's branch changes nothing)
    return m


# --------------------------------------------------------------------------
# Param logical axes by (leaf name, ndim). Stacked scan units prepend a
# "layers" dim which is never sharded.
# --------------------------------------------------------------------------
_PARAM_AXES = {
    ("embed", 2): ("vocab", "dmodel_w"),
    ("lm_head", 2): ("dmodel_w", "vocab"),
    ("wq", 2): ("dmodel_w", "qdim"),
    ("wk", 2): ("dmodel_w", "kvdim"),
    ("wv", 2): ("dmodel_w", "kvdim"),
    ("wo", 2): ("qdim", "dmodel_w"),
    ("bq", 1): ("qdim",),
    ("bk", 1): ("kvdim",),
    ("bv", 1): ("kvdim",),
    ("w1", 2): ("dmodel_w", "ff"),
    ("w3", 2): ("dmodel_w", "ff"),
    ("w2", 2): ("ff", "dmodel_w"),
    ("b1", 1): ("ff",),
    ("b2", 1): (None,),
    ("router", 2): ("dmodel_w", None),
    ("w1", 3): ("expert", "dmodel_w", "ff_exp"),
    ("w3", 3): ("expert", "dmodel_w", "ff_exp"),
    ("w2", 3): ("expert", "ff_exp", "dmodel_w"),
    ("in_x", 2): ("dmodel_w", "lru"),
    ("in_gate", 2): ("dmodel_w", "lru"),
    ("out", 2): ("lru", "dmodel_w"),
    ("w_ig", 1): ("lru",),
    ("b_ig", 1): ("lru",),
    ("w_rg", 1): ("lru",),
    ("b_rg", 1): ("lru",),
    ("a_param", 1): ("lru",),
    ("up", 2): ("dmodel_w", "inner"),
    ("down", 2): ("inner", "dmodel_w"),
    ("w_if", 2): ("inner", None),
    ("b_if", 1): (None,),
    ("head_norm", 1): (None,),
    ("w_gates", 2): ("dmodel_w", "inner"),
    ("r_gates", 3): (None, None, None),
    ("b_gates", 1): (None,),
    ("up1", 2): ("dmodel_w", "inner"),
    ("up2", 2): ("dmodel_w", "inner"),
    ("w", 2): (None, "lru"),        # conv kernels (width, channels)
    ("wq", 3): (None, None, None),  # mLSTM per-head block-diag projections
    ("wk", 3): (None, None, None),
    ("wv", 3): (None, None, None),
}


def _leaf_logical_axes(path, ndim):
    """Logical axes of the leaf at ``path`` (its keys, root first) in the
    reference's parameter tree."""
    name = None
    stacked = False
    for key in path:
        if key == "units":
            stacked = True
        if isinstance(key, str) and key != "units":
            name = key
    # scanned stacks have a leading layer dim; try the right rank first so a
    # stacked 2D weight isn't confused with a native 3D (MoE) weight.
    order = (1, 0) if stacked else (0, 1)
    for extra in order:
        axes = _PARAM_AXES.get((name, ndim - extra))
        if axes is not None:
            return (None,) * extra + tuple(axes)
    return (None,) * ndim  # norms, scalars, unknown -> replicate


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (the reference's trees: dicts
    all the way down), keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, rules: ShardingRules):
    """PartitionSpec tree matching ``params`` (the reference's layout;
    leaves need ``shape``)."""
    def leaf_spec(path, leaf):
        axes = _leaf_logical_axes(path, len(leaf.shape))
        return rules.spec(axes, dims=tuple(leaf.shape))
    return map_with_path(leaf_spec, params)


def cache_specs(cache, rules: ShardingRules):
    """Specs for decode caches in the reference's layout: KV caches
    (layers, B, Hkv, S, hd) and recurrent states (leading layers dim, then
    batch)."""
    def leaf_spec(path, leaf):
        ndim = len(leaf.shape)
        kv = "k" in path or "v" in path
        if kv:
            axes = ("layers", "cache_batch", "kv_heads", "cache_seq",
                    "head_dim")
            axes = axes[-ndim:]
        else:
            axes = ("layers", "cache_batch") + (None,) * (ndim - 2)
            axes = axes[:ndim]
        axes = tuple(a if a not in ("layers",) else None for a in axes)
        spec = rules.spec(axes, dims=tuple(leaf.shape))
        # GQA caches with kv_heads < model-axis size: fall back to sharding
        # head_dim over 'model' so big-arch caches still split 16 ways
        if kv and ndim >= 2:
            parts = list(spec)
            try:
                kv_pos = axes.index("kv_heads")
                hd_pos = axes.index("head_dim")
            except ValueError:
                return spec
            model_size = rules.axis_sizes.get("model", 1)
            if (parts[kv_pos] is None and parts[hd_pos] is None
                    and leaf.shape[hd_pos] % model_size == 0
                    and rules.mapping.get("kv_heads") == "model"):
                parts[hd_pos] = "model"
                return PartitionSpec(*parts)
        return spec
    return map_with_path(leaf_spec, cache)
