"""Dry-run: count every (architecture x input-shape) cell on the reference's
meshes and on one card; the counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step with XLA for 256 or
512 placeholder devices and reads the compiler's memory and cost
analyses. The port runs the cell's step once on ``meta`` tensors (shapes
and dtypes only: nothing is allocated, no card is needed) with the
dtypes and kernel routes of the port on an H100 (``device.meta_as``), under
``analysis.hlo.OpCounter``, and records per device:

  * ``argument_bytes``: the step's inputs (``launch.specs.input_specs``)
    cut to each device's shard by the sharding rules
    (``launch.sharding``);
  * the counter's ``flops``, ``bytes_accessed`` (HBM bytes) and
    ``transcendentals``, divided by the mesh's devices, and the kernels it
    counted;
  * ``param_count`` and ``active_param_count`` of the config, the first
    checked against the meta model's own count (``meta_param_count``: the
    analytic count leaves out some norm scales and biases, so the two may
    differ by no more than the model's 1-d parameters);
  * on the ``local`` mesh (one card), the step's ``peak_bytes``: the
    arguments plus the most bytes the step holds at once (allocations
    minus frees, saved activations included). A cell over the card's
    memory is reported with the depth that would fit, as
    ``launch/train.py``'s ``check_fits`` reports a model; it is not an
    error.

Loops over time count one trip and multiply (``analysis.hlo.unrolled``),
so ``--all --mesh all`` takes minutes on a host CPU. Results go to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``; a cell
already there is skipped unless ``--force``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape train_4k --mesh local
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.analysis import hlo
from repro_torch.analysis.roofline import HBM_PER_CARD, RESULTS
from repro_torch.configs import SHAPES, all_configs
from repro_torch.device import meta_as
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, one_card_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.train import FIT_SHARE, depth_that_fits
from repro_torch.models import transformer as tf
from repro_torch.nn.layers import bf16_backward_scope, compute_dtype

MESHES = ("single", "multi", "local")


def mesh_for(kind: str):
    if kind == "local":
        return one_card_mesh()
    return make_production_mesh(multi_pod=kind == "multi")


def cell_applicable(cfg, shape_name) -> bool:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False
    return True


def parse_overrides(pairs):
    """--override key=value (int/float/str/bool inferred) for §Perf variants."""
    out = {}
    for pair in pairs or ():
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


# ------------------------------------------------------------------ counting
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def count_step(cfg, kind: str, batch: int, seq: int,
               device="cuda") -> dict:
    """Run one step of ``kind`` ("train", "prefill", "decode") of ``cfg``
    at ``batch`` x ``seq`` on meta tensors standing for ``device``, under
    an op counter. Returns the counts (``analysis.hlo``'s keys, with
    ``peak_bytes`` the most the step held at once beyond its arguments),
    ``argument_bytes`` (whole, unsharded), ``meta_param_count`` and the
    seconds the count took. A train step is ``launch.steps``'s (loss,
    backward, AdamW); prefill ``models.transformer.prefill`` of a
    ``seq``-token prompt; decode one token into a cache of ``seq``
    positions."""
    t0 = time.perf_counter()
    frames = cfg.embed_mode == "frames"
    with meta_as(device):
        model = tf.Transformer(cfg, "meta", trainable=kind == "train")
        dt = compute_dtype(device)
        if kind == "train":
            state = steps.state_of(model)
            data = {"inputs": _meta((batch, seq, cfg.d_model), dt) if frames
                    else _meta((batch, seq), torch.int32),
                    "labels": _meta((batch, seq), torch.int32)}
            args = (state, data)
            fn = steps.make_train_step(cfg)
            arg_bytes = _nbytes([dict(model.named_parameters()),
                                 state["opt"], data])
        else:
            shape = (batch, seq if kind == "prefill" else 1)
            inputs = _meta((*shape, cfg.d_model), dt) if frames \
                else _meta(shape, torch.int32)
            if kind == "prefill":
                args = (model, {"inputs": inputs})
                fn = torch.no_grad()(steps.make_prefill_step(cfg))
                arg_bytes = _nbytes([dict(model.named_parameters()), inputs])
            else:
                cache = tf.init_cache(cfg, batch, seq, "meta")
                args = (model, cache, inputs, seq - 1)
                fn = torch.no_grad()(steps.make_decode_step(cfg))
                arg_bytes = _nbytes([dict(model.named_parameters()), cache,
                                     inputs])
        with bf16_backward_scope(cfg.bwd_dtype == "bfloat16"):
            counts, _ = hlo.analyze(fn, *args)
    counts["argument_bytes"] = arg_bytes
    counts["meta_param_count"] = sum(p.numel() for p in model.parameters())
    counts["meta_vector_params"] = sum(p.numel() for p in model.parameters()
                                       if p.dim() <= 1)
    counts["count_s"] = time.perf_counter() - t0
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _shard_bytes(tree, specs, rules) -> int:
    total = 0
    for leaf, spec in zip(_leaves(tree), _leaves(specs)):
        n = 1
        for d in shd.shard_shape(tuple(leaf.shape), spec, rules):
            n *= d
        total += n * leaf.element_size()
    return total


def argument_bytes_per_device(cfg, shape_name: str, mesh) -> int:
    """Bytes of the step's inputs on each device of ``mesh`` under the
    baseline rules (the reference's ``shardings_for``)."""
    cell = SHAPES[shape_name]
    multi_pod = "pod" in mesh.axis_names
    mapping = shd.baseline_mapping(multi_pod,
                                   long_context=cell.name == "long_500k",
                                   serve=cell.kind != "train",
                                   expert_sharding=cfg.expert_sharding)
    rules = shd.ShardingRules(mesh, mapping)
    ins = input_specs(cfg, shape_name)

    def batch_sharded(tree):
        return shd.map_with_path(lambda _, x: rules.spec(
            ("batch",) + (None,) * (len(x.shape) - 1), tuple(x.shape)), tree)

    if cell.kind == "train":
        params = ins["state"]["params"]
        pspecs = shd.param_specs(params, rules)
        per = _shard_bytes(params, pspecs, rules)
        return (3 * per + _nbytes(ins["state"]["opt"]["count"])
                + _nbytes(ins["state"]["step"])
                + _shard_bytes(ins["batch"], batch_sharded(ins["batch"]),
                               rules))
    params = ins["params"]
    per = _shard_bytes(params, shd.param_specs(params, rules), rules)
    if cell.kind == "prefill":
        return per + _shard_bytes(ins["batch"], batch_sharded(ins["batch"]),
                                  rules)
    cache = ins["cache"]
    return (per + _shard_bytes(cache, shd.cache_specs(cache, rules), rules)
            + _shard_bytes({"i": ins["inputs"]},
                           batch_sharded({"i": ins["inputs"]}), rules)
            + _nbytes(ins["pos"]))


def _fit(cfg, kind: str, batch: int, seq: int, peak: int,
         memory: int = HBM_PER_CARD) -> dict:
    """Whether a step of ``peak`` bytes fits one card, and if not the
    depth that would: the layers that keep the step's peak within the
    card, from the peak of one pattern unit counted the same way, taken as
    linear in depth; for training also no more than
    ``launch.train.depth_that_fits`` gives (the float32 state within
    FIT_SHARE of the card), ``check_fits``'s rule."""
    if peak <= memory:
        return {"fits": True}
    unit = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    c1 = count_step(unit, kind, batch, seq)
    p1 = c1["argument_bytes"] + c1["peak_bytes"]
    per_unit = (peak - p1) / max(cfg.num_units - 1, 1)
    units = 0
    if p1 <= memory:
        units = cfg.num_units if per_unit <= 0 else \
            min(cfg.num_units, 1 + int((memory - p1) // per_unit))
    depth = units * len(cfg.pattern)
    rule = "the step's peak within the card, linear in depth"
    if kind == "train":
        depth = min(depth, depth_that_fits(cfg, memory))
        rule += (f", and the float32 weights, gradients and AdamW moments "
                 f"within {FIT_SHARE:.0%} of it")
    why = "" if depth else "; not one unit fits at this batch"
    return {"fits": False, "depth_that_fits": depth,
            "message": f"{cfg.name} needs {peak / 2**30:.1f} GiB at this "
                       f"cell, more than the card's {memory / 2**30:.1f} "
                       f"GiB: cut its depth to {depth} of its "
                       f"{cfg.num_layers} layers ({rule}){why}"}


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None,
             counts: dict | None = None) -> dict:
    """One cell's record (see the module docstring). ``counts``: a
    :func:`count_step` of this (arch, shape) already made (the count does
    not depend on the mesh)."""
    cfg = all_configs()[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape_name]
    mesh = mesh_for(mesh_kind)
    if counts is None:
        counts = count_step(cfg, cell.kind, cell.global_batch, cell.seq_len)
    # the config's analytic count leaves out some norm scales and biases:
    # the meta model may hold more, by no more than its 1-d parameters
    gap = counts["meta_param_count"] - cfg.param_count()
    if not 0 <= gap <= counts["meta_vector_params"]:
        raise AssertionError(f"{arch}: the meta model holds "
                             f"{counts['meta_param_count']} parameters, "
                             f"the config counts {cfg.param_count()}")
    dev = mesh.size
    args = argument_bytes_per_device(cfg, shape_name, mesh)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "devices": dev,
        "count_s": round(counts["count_s"], 3),
        "memory": {"argument_bytes": args},
        "cost": {"flops": counts["flops"] / dev,
                 "tensor_core_flops": counts["tensor_core_flops"] / dev,
                 "bytes_accessed": counts["hbm_bytes"] / dev,
                 "transcendentals": counts["transcendentals"] / dev},
        "collectives": {"total_bytes": 0.0},
        "collective_link_bytes": counts["collective_link_bytes"] / dev,
        "kernels": counts["kernels"],
        "kernel_flops": counts["kernel_flops"] / dev,
        "kernel_bytes": counts["kernel_bytes"] / dev,
        "op_counts": counts["op_counts"],
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "meta_param_count": counts["meta_param_count"],
    }
    if mesh_kind == "local":
        peak = counts["argument_bytes"] + counts["peak_bytes"]
        result["memory"].update(temp_bytes=counts["peak_bytes"],
                                peak_bytes=peak)
        result["memory"].update(_fit(cfg, cell.kind, cell.global_batch,
                                     cell.seq_len, peak))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "local", "both", "all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=None,
                    help="cfg field override key=value (repeatable)")
    ap.add_argument("--tag", default="",
                    help="suffix for result files (perf variants)")
    args = ap.parse_args()
    overrides = parse_overrides(args.override)

    RESULTS.mkdir(parents=True, exist_ok=True)
    archs = sorted(all_configs()) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"both": ["single", "multi"], "all": list(MESHES)}.get(
        args.mesh, [args.mesh])

    t_all = time.perf_counter()
    failures = []
    for arch in archs:
        cfg = all_configs()[arch]
        for shape_name in shapes:
            counts = None
            for mesh_kind in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                out = RESULTS / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
                if out.exists() and not args.force:
                    print(f"[skip] {out.name} exists")
                    continue
                if not cell_applicable(cfg, shape_name):
                    out.write_text(json.dumps({
                        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
                        "skipped": "long_500k needs sub-quadratic attention; "
                                   "this arch is pure full-attention"}))
                    print(f"[SKIP] {arch} x {shape_name} (full attention)")
                    continue
                print(f"[run ] {arch} x {shape_name} x {mesh_kind} "
                      f"{overrides or ''}...", flush=True)
                try:
                    if counts is None:
                        c = dataclasses.replace(cfg, **overrides) \
                            if overrides else cfg
                        cell = SHAPES[shape_name]
                        counts = count_step(c, cell.kind, cell.global_batch,
                                            cell.seq_len)
                    res = run_cell(arch, shape_name, mesh_kind, overrides,
                                   counts)
                    if args.tag:
                        res["tag"] = args.tag
                        res["overrides"] = overrides
                    out.write_text(json.dumps(res, indent=1))
                    mem = res["memory"]
                    fit = "" if "fits" not in mem else (
                        f" peak={mem['peak_bytes'] / 2**30:.1f}GiB "
                        f"fits={mem['fits']}")
                    print(f"[ ok ] {arch} x {shape_name} x {mesh_kind}: "
                          f"flops/dev={res['cost']['flops']:.3e} "
                          f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB"
                          f"{fit} count={res['count_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((arch, shape_name, mesh_kind, repr(e)))
                    traceback.print_exc()
    print(f"\nwall {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("all requested dry-run cells OK")


if __name__ == "__main__":
    main()
