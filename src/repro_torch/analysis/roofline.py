"""Roofline per (arch x shape x mesh) from the dry-run's records; the
counterpart of ``repro/analysis/roofline.py``.

Terms (seconds, per step, per device; the dry-run divides its counts by
the mesh's devices):

    compute    = tensor_core_flops / BF16_TC_FLOPS
                 + (flops - tensor_core_flops) / FP32_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = collective_link_bytes / LINK_BW      (0 on one card)

The counts come from ``analysis.hlo`` (the step run on meta tensors, its
kernels counted as the card runs them). MODEL_FLOPS = 6 N_active D (train)
or 2 N_active D (prefill, decode) counts the *useful* work; its ratio to
the counted flops exposes recompute and the dense MoE dispatch's waste.

Hardware: one "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi): 3.35 TB/s
of device memory, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s
float32 outside them (the rates every kernel's bound is taken at), 80 GB
of memory, and NVLink at 450 GB/s a direction for the collective term of
a mesh of several cards.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.configs import SHAPES, all_configs

HBM_BW = 3.35e12                 # bytes/s
BF16_TC_FLOPS = 989e12           # dense bf16 on the tensor cores
FP32_FLOPS = 67e12               # float32 outside the tensor cores
LINK_BW = 450e9                  # NVLink, bytes/s a direction
HBM_PER_CARD = 80 * 10**9         # bytes of device memory, nominal

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"


def model_flops_per_device(cfg, cell, devices: int) -> float:
    n_active = cfg.active_param_count()
    if cfg.embed_mode == "tokens":
        n_active -= cfg.vocab_size * cfg.d_model   # input embed is a gather
    if cell.kind == "train":
        tokens = cell.seq_len * cell.global_batch
        return 6.0 * n_active * tokens / devices
    if cell.kind == "prefill":
        tokens = cell.seq_len * cell.global_batch
        return 2.0 * n_active * tokens / devices
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch / devices


def compute_seconds(flops: float, tensor_core_flops: float) -> float:
    return (tensor_core_flops / BF16_TC_FLOPS
            + (flops - tensor_core_flops) / FP32_FLOPS)


def _advice(dominant, cfg, cell, ratio):
    if dominant == "compute":
        if cfg.ffn == "moe" and cfg.moe_impl == "dense":
            return ("switch MoE to the capacity-bounded dispatch "
                    "(moe_impl='dropping'): the dense dispatch computes all "
                    f"{cfg.n_experts} experts for every token; useful ratio "
                    f"{ratio:.2f}")
        if cell.kind == "train":
            return ("relax remat (full -> dots) to cut the backward's "
                    "recompute")
        return ("keep the products in bf16 on the tensor cores; float32 "
                "elementwise passes and float32 products run at 67, not "
                "989 TFLOP/s")
    if dominant == "memory":
        if cell.kind == "decode":
            return ("the weights and KV cache are read once a token: batch "
                    "more requests a step")
        return ("reduce activation traffic: eager PyTorch writes every "
                "elementwise result; fuse the float32 gate and norm passes "
                "into the kernels around them")
    return ("shard so the dominant collective's tensor is replicated, or "
            "overlap it with compute")


def cell_roofline(cfg, cell, cost: dict, devices: int = 1,
                  collective_link_bytes: float = 0.0) -> dict:
    """The roofline terms of a step of ``cfg`` at ``cell`` (a ``ShapeCell``)
    from its counts per device (``flops``, ``tensor_core_flops`` and
    ``hbm_bytes``, or the dry-run's ``bytes_accessed``)."""
    flops = cost["flops"]
    t_c = compute_seconds(flops, cost.get("tensor_core_flops", 0.0))
    t_m = cost.get("hbm_bytes", cost.get("bytes_accessed")) / HBM_BW
    t_x = collective_link_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(cfg, cell, devices)
    ratio = mf / max(flops, 1.0)
    # fraction of roofline: the time the useful flops need on the tensor
    # cores vs the time the dominant term costs
    step_time = max(terms.values())
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dominant, "bound_s": step_time,
            "model_flops_dev": mf, "counted_flops_dev": flops,
            "useful_ratio": ratio,
            "roofline_fraction": (mf / BF16_TC_FLOPS) / max(step_time, 1e-30),
            "advice": _advice(dominant, cfg, cell, ratio)}


def roofline_row(result: dict) -> dict:
    """The roofline of one dry-run record."""
    cfg = all_configs()[result["arch"]]
    cell = SHAPES[result["shape"]]
    mem = result.get("memory", {})
    row = {"arch": result["arch"], "shape": result["shape"],
           "mesh": result["mesh"], "devices": result["devices"],
           "hbm_fit": mem.get("peak_bytes", mem.get("argument_bytes", 0))}
    row.update(cell_roofline(cfg, cell, result["cost"], result["devices"],
                             result.get("collective_link_bytes", 0.0)))
    return row


def analyze_cell(results_dir: pathlib.Path, arch: str, shape: str,
                 mesh: str = "local") -> dict | None:
    jf = pathlib.Path(results_dir) / f"{arch}__{shape}__{mesh}.json"
    if not jf.exists():
        return None
    result = json.loads(jf.read_text())
    if "skipped" in result:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "skipped": result["skipped"]}
    return roofline_row(result)


def full_table(results_dir=RESULTS, mesh="local") -> list[dict]:
    rows = []
    for arch in sorted(all_configs()):
        for shape in SHAPES:
            row = analyze_cell(pathlib.Path(results_dir), arch, shape, mesh)
            if row is not None:
                rows.append(row)
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful ratio | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP "
                         f"| — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} |")
    return hdr + "\n".join(lines)
