"""Elastic restart: restore a training state onto another mesh; the port
of ``repro/train/elastic.py``.

The versioned checkpoint and the deterministic data views make elasticity
a pure data-management operation (the paper's thesis): resolve
``snapshot(v)``, derive each leaf's spec on the new mesh from the same
logical rules (``launch.sharding``), move each leaf to its device, and
continue. The batch index continues from the restored step, so no sample
is lost or repeated.

The checkpoints hold the reference's train-state tree, so either package
restores the other's. The port trains on one device: a mesh of the port
(``launch.mesh.make_local_mesh``) places every leaf whole on its first
device, the card or the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.models.params import flatten_tree, reference_path
from repro_torch.train.data import TokenPipeline


@dataclasses.dataclass(frozen=True)
class Placement:
    spec: shd.PartitionSpec
    device: torch.device | None      # None on a declared mesh
    shard_shape: tuple


def plan_resharding(cfg, params_like, old_mesh, new_mesh, *,
                    multi_pod_new=False):
    """Each parameter leaf's :class:`Placement` on ``new_mesh``: its spec
    from the baseline rules (a dimension the mesh cannot split evenly is
    replicated, the rules' fallback), the device it lands on and its shard
    shape. ``params_like``: the reference's parameter tree (arrays or
    tensors with ``shape``). ``old_mesh`` is not read, as in the
    reference."""
    mapping = shd.baseline_mapping(multi_pod_new,
                                   expert_sharding=cfg.expert_sharding)
    rules = shd.ShardingRules(new_mesh, mapping)
    specs = shd.param_specs(params_like, rules)
    device = new_mesh.devices[0] if new_mesh.devices else None

    def place(path, leaf):
        spec = _at(specs, path)
        return Placement(spec, device,
                         shd.shard_shape(tuple(leaf.shape), spec, rules))
    return shd.map_with_path(place, params_like)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reshard(tree, placements):
    """Move each leaf of ``tree`` (NumPy arrays or tensors) to its
    placement's device as a tensor; the port holds every leaf whole, so a
    placement that would split a leaf across devices is refused."""
    def move(path, leaf):
        p = _at(placements, path)
        if tuple(p.shard_shape) != tuple(leaf.shape):
            raise ValueError(f"{'/'.join(path)}: the port holds leaves "
                             f"whole, this one would split to "
                             f"{p.shard_shape}")
        if p.device is None:
            raise ValueError("a declared mesh has no device to move to")
        return torch.as_tensor(leaf).to(p.device)
    return shd.map_with_path(move, tree)


def _port_tensors(tree: dict, names) -> dict:
    """{port tensor name: the tensor of the reference-layout ``tree`` it
    is}: a unit's row of a stacked leaf is a view of it (a contiguous row),
    so nothing is copied."""
    flat = flatten_tree(tree)
    out = {}
    for name in names:
        path, row = reference_path(name)
        out[name] = flat[path] if row is None else flat[path][row]
    return out


def elastic_restart(cfg, ckpt_manager, state_like, new_mesh, *,
                    version=None, multi_pod_new=False):
    """snapshot(v) -> reshard -> resume. ``state_like``: the reference's
    train-state structure (``launch.steps.reference_state_like(cfg)``).
    Returns a port train state (``launch.steps``) on ``new_mesh``'s
    device whose step, and so the next batch index, is the restored step.
    Each leaf is moved once: the model's parameters and the moments are
    the moved leaves themselves (a unit's tensors are rows of its stacked
    leaf), not copies of them."""
    tree = ckpt_manager.restore(state_like, version)
    placements = plan_resharding(cfg, tree["params"], None, new_mesh,
                                 multi_pod_new=multi_pod_new)
    model = tf.Transformer(cfg, "meta", trainable=True)
    names = [n for n, _ in model.named_parameters()]
    params = _port_tensors(reshard(tree["params"], placements), names)
    for name, t in params.items():
        owner, attr = model.get_submodule(name.rpartition(".")[0]), \
            name.rpartition(".")[2]
        owner._parameters[attr] = torch.nn.Parameter(t, requires_grad=True)
    state = {"params": model,
             "opt": {k: _port_tensors(reshard(tree["opt"][k], placements),
                                      names) for k in ("m", "v")},
             "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}
    state["opt"]["count"] = torch.tensor(int(tree["opt"]["count"]),
                                         dtype=torch.int32)
    return state


def continue_training(cfg, state, *, steps_n: int, batch: int, seq: int,
                      seed: int = 0) -> dict:
    """Train ``state`` for ``steps_n`` more steps, batch index continuing
    from its step (the data pipeline of ``launch.train.run``, same seed).
    Returns {batch index: loss}."""
    step_fn = steps.make_train_step(cfg)
    pipe = TokenPipeline(
        cfg.vocab_size, batch, seq, seed=seed,
        frames_dim=cfg.d_model if cfg.embed_mode == "frames" else None)
    losses = {}
    first = int(state["step"])
    for i in range(first, first + steps_n):
        state, metrics = step_fn(state, pipe.batch_view(i).value())
        losses[i] = float(metrics["loss"])
    return losses
