"""The PyTorch port stands alone: importing every ``repro_torch`` module
loads neither JAX nor anything of the JAX package ``repro``."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list[str]:
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("core.versioned", "core.snapshotter", "core.replica",
              "kernels.ref", "kernels.snapshot_resolve", "kernels.segment_sum",
              "kernels.ops", "graph.dyngraph", "graph.compute",
              "train.checkpoint", "graph.wal", "graph.sharded", "graph.query",
              "launch.serve_graph", "configs", "configs.base",
              "configs.recurrentgemma_2b", "nn.layers", "nn.rope",
              "kernels.lru_scan", "nn.recurrent", "kernels.flash_attention",
              "nn.attention", "models.transformer", "models.params",
              "launch.steps", "launch.serve", "core.clock",
              "core.protocol_dataflow", "core.views", "graph.schema",
              "graph.reference", "graph.models", "graph.partition",
              "launch.rpc", "configs.qwen2_5_14b", "train.optimizer",
              "train.loss", "train.data", "train.compression",
              "launch.train", "configs.qwen1_5_110b",
              "configs.starcoder2_7b", "configs.gemma3_27b",
              "configs.internvl2_76b", "configs.musicgen_medium",
              "nn.moe", "configs.mixtral_8x22b", "configs.phi3_5_moe",
              "launch.mesh", "launch.sharding", "launch.specs",
              "launch.dryrun", "analysis.hlo", "analysis.roofline",
              "analysis.report", "train.elastic"):
        assert f"repro_torch.{m}" in mods, m
    for src in ("snapshot_resolve.cu", "segment_sum.cu", "lru_scan.cu",
                "flash_attention.cu", "flash_attention_bwd.cu"):
        assert (SRC / "repro_torch" / "csrc" / src).is_file()


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_imports_no_jax_and_no_repro():
    """``chip_smoke.py`` runs on a machine without JAX: none of its
    imports, at any depth of the file, names ``jax`` or ``repro``."""
    import ast
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(names)


def test_every_reference_module_has_a_counterpart():
    """Every module of ``src/repro/`` has a port at the same path under
    ``src/repro_torch/`` but the source linter ``analysis/staticcheck``,
    a repository tool that imports no JAX and runs over either package."""
    def modules(pkg):
        root = SRC / pkg
        return {str(p.relative_to(root)) for p in root.rglob("*.py")}
    missing = sorted(modules("repro") - modules("repro_torch"))
    assert missing and all(m.startswith("analysis/staticcheck/")
                           for m in missing), missing
