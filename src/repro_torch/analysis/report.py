"""Print the dry-run's tables from ``results/dryrun_torch/``; the
counterpart of ``repro/analysis/report.py``.

    PYTHONPATH=src python -m repro_torch.analysis.report > dryrun_tables.md

Three dry-run tables (the single-pod and multi-pod meshes, declared, and
one card) and the roofline table of one card. The records come from
``python -m repro_torch.launch.dryrun``; :func:`variant_rows` tabulates
the records of its ``--tag`` runs (perf variants).
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.analysis.roofline import (RESULTS, full_table, roofline_row,
                                          to_markdown)
from repro_torch.configs import SHAPES, all_configs

GIB = 1024 ** 3


def dryrun_table(mesh: str, results_dir=RESULTS) -> str:
    local = mesh == "local"
    rows = ["| arch | shape | devices | count s | args GiB/dev "
            + ("| peak GiB | fits one card |" if local else "")
            + "| flops/dev | HBM bytes/dev |",
            "|---|---|---|---|---|" + ("---|---|" if local else "")
            + "---|---|"]
    for arch in sorted(all_configs()):
        for shape in SHAPES:
            f = pathlib.Path(results_dir) / f"{arch}__{shape}__{mesh}.json"
            if not f.exists():
                continue
            d = json.loads(f.read_text())
            if "skipped" in d:
                rows.append(f"| {arch} | {shape} | — | — | — | "
                            + ("— | — | " if local else "") + "SKIP | — |")
                continue
            mem = d["memory"]
            fit = ""
            if local:
                fit = (f"| {mem['peak_bytes'] / GIB:.2f} | "
                       + ("yes" if mem["fits"] else
                          f"no: {mem['depth_that_fits']} of "
                          f"{all_configs()[arch].num_layers} layers") + " ")
            rows.append(
                f"| {arch} | {shape} | {d['devices']} | {d['count_s']} "
                f"| {mem['argument_bytes'] / GIB:.2f} {fit}"
                f"| {d['cost']['flops']:.3e} "
                f"| {d['cost']['bytes_accessed']:.3e} |")
    return "\n".join(rows)


def variant_rows(tags: list[tuple[str, str, str]],
                 results_dir=RESULTS) -> str:
    """The perf-variant table: a row per (arch, shape, tag) whose
    single-pod record ``<arch>__<shape>__single[__<tag>].json`` exists
    (``python -m repro_torch.launch.dryrun --tag <tag> --override ...``;
    an empty tag is the baseline), with its roofline terms in seconds,
    the dominant one and the roofline fraction. The reference reads the
    terms from its HLO text; the port's dry-run counted them on meta
    tensors into the record."""
    out = ["| cell | variant | compute s | memory s | collective s "
           "| dominant | roofline frac |",
           "|---|---|---|---|---|---|---|"]
    for arch, shape, tag in tags:
        suffix = f"__{tag}" if tag else ""
        f = pathlib.Path(results_dir) / f"{arch}__{shape}__single{suffix}.json"
        if not f.exists():
            continue
        d = json.loads(f.read_text())
        if "skipped" in d:
            continue
        r = roofline_row(d)
        out.append(f"| {arch} {shape} | {tag or 'baseline'} "
                   f"| {r['compute_s']:.2f} | {r['memory_s']:.2f} "
                   f"| {r['collective_s']:.2f} | {r['dominant']} "
                   f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main():
    print("## Dry-run (single-pod 16x16 = 256 cards, declared)\n")
    print(dryrun_table("single"))
    print("\n## Dry-run (multi-pod 2x16x16 = 512 cards, declared)\n")
    print(dryrun_table("multi"))
    print("\n## Dry-run (one NVIDIA H100 80GB HBM3)\n")
    print(dryrun_table("local"))
    print("\n## Roofline (one card, per (arch x shape))\n")
    print(to_markdown(full_table(RESULTS, "local")))


if __name__ == "__main__":
    main()
