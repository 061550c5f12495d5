"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``bench/configs/<config>.json`` (the file the
manifest's configuration entry names), its traffic mix
``bench/traffic/<traffic>.json``, each metric's reader
``bench/metrics/<metric>.py`` and each kernel's roofline count
``bench/roofline/<kernel>.py``. Nothing here names a cell: a later cell,
mix, metric or count is new files and new manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload``."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(by_name)}")
    w = by_name[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return w, config, traffic


def metrics_for(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, that list the cell or list none."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
