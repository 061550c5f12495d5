"""The port's dry-run against the JAX package's, and its op counter.

The input specs of every architecture and shape cell equal the
reference's (the reference run in a subprocess with ``REPRO_FORCE_BF16=1``,
its dry-run's dtypes; nothing is lowered or compiled). The op counter
(``analysis/hlo.py``) is held to the reference analyzer's two tests (10
trips of an 8 x 8 product, the ring all-reduce's link bytes) and to
product counts written out here; a counted step allocates nothing; the
roofline and the report read the records; and ``chip_smoke.py`` phase
12b rehearses on the host.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import resource
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import hlo, report, roofline  # noqa: E402
from repro_torch.configs import SHAPES, all_configs, get_config  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from _torch_parity import reference_archs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's ten (the port's own architectures have no reference
# specs to hold them to)
ARCHS = reference_archs()

_SPECS_SCRIPT = r"""
import json
import jax
from repro.configs import SHAPES, all_configs
from repro.launch.specs import input_specs
out = {}
for arch in sorted(all_configs()):
    for shape in SHAPES:
        tree = input_specs(all_configs()[arch], shape)
        out[f"{arch}|{shape}"] = {
            "/".join(k.key for k in path): [list(x.shape), str(x.dtype)]
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               REPRO_FORCE_BF16="1")
    proc = subprocess.run([sys.executable, "-c", _SPECS_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, reference_specs):
    """Shapes and dtypes of every input of every shape cell equal the
    reference's forced-bf16 specs, but a serving cell's parameters: the
    port serves in bf16 exactly the weights ``nn.layers.weight_dtype``
    gives bf16 on a card, where the reference counts ``param_dtype``."""
    cfg = all_configs()[arch]
    for shape in SHAPES:
        want = reference_specs[f"{arch}|{shape}"]
        got = _flat(specs.input_specs(cfg, shape))
        assert set(got) == set(want), (arch, shape)
        for k, (wshape, wdtype) in want.items():
            t = got[k]
            assert t.is_meta and list(t.shape) == wshape, (arch, shape, k)
            dtype = str(t.dtype).removeprefix("torch.")
            if k.startswith("params/") and _served_in_bf16(cfg, k):
                assert (dtype, wdtype) == ("bfloat16", "float32"), (
                    arch, shape, k)
            else:
                assert dtype == wdtype, (arch, shape, k, dtype, wdtype)


# the weights that only dense products or the embedding gather read
_DENSE = {"embed", "lm_head", "wq", "wk", "wv", "wo", "w1", "w2", "w3",
          "in_x", "in_gate", "out", "up", "down", "up1", "up2"}


def _served_in_bf16(cfg, path: str) -> bool:
    """Whether the port serves the parameter at ``path`` (the reference's
    tree) in bf16 on a card: a dense-only weight, but the mLSTM's per-head
    q, k, v projections, which the reference reads in float32."""
    parts = path.split("/")
    name = parts[-1]
    if name not in _DENSE:
        return False
    block = parts[2] if parts[1] == "units" else parts[1]
    kinds = cfg.pattern if parts[1] == "units" else cfg.tail_pattern
    kind = kinds[int(block.removeprefix("b").removeprefix("tail"))] \
        if block.startswith(("b", "tail")) else None
    return not (kind == "mlstm" and name in ("wq", "wk", "wv"))


def test_analyzer_counts_a_loop_of_products():
    """The reference's ``test_hlo_analyzer_counts_loops``: 10 trips of an
    8 x 8 product, 2 * 8^3 flops each, as a plain loop and through
    ``unrolled`` (two trips run, the second counted nine times)."""
    x = torch.empty(8, 8, device="meta")

    def plain(x):
        for _ in range(10):
            x = x @ x
        return x

    def looped(x):
        c, _ = hlo.unrolled(10, lambda i, c: (c @ c, None), x)
        return c
    for fn in (plain, looped):
        r, out = hlo.analyze(fn, x)
        assert r["flops"] == r["product_flops"] == 10 * 2 * 8 ** 3
        assert r["op_counts"]["aten.mm"] == 10
        assert out.shape == (8, 8) and out.is_meta
        assert r["collective_link_bytes"] == 0 and r["collectives"] == {}


def test_analyzer_counts_a_loop_backward_as_unrolled():
    """Under grad, the loop's backward through ``unrolled`` counts what
    the plain loop's does: the nodes of the second trip n - 1 times, the
    sums of a weight's gradient over the trips included."""
    w = torch.empty(8, 8, device="meta", requires_grad=True)

    def run(unroll):
        def fn():
            c0 = torch.empty(8, 8, device="meta")
            if unroll:
                c, ys = hlo.unrolled(10, lambda i, c: (torch.tanh(c @ w),
                                                       None), c0)
            else:
                c = c0
                for _ in range(10):
                    c = torch.tanh(c @ w)
            c.sum().backward()
            w.grad = None
        r, _ = hlo.analyze(fn)
        return r
    plain, unrolled = run(False), run(True)
    assert unrolled["product_flops"] == plain["product_flops"] == 29 * 1024
    assert unrolled["transcendentals"] == plain["transcendentals"] == 640
    assert unrolled["op_counts"]["aten.add"] == 9


def test_analyzer_ring_all_reduce_bytes():
    """The reference's ``test_hlo_analyzer_collectives``: a ring
    all-reduce of 1024 bytes over 4 devices sends 2 * 0.75 * 1024."""
    assert hlo.ring_link_bytes("all-reduce", 1024, 4) == 2 * 0.75 * 1024
    assert hlo.ring_link_bytes("all-gather", 1024, 4) == 0.75 * 1024
    assert hlo.ring_link_bytes("reduce-scatter", 1024, 4) == 3 * 1024
    assert hlo.ring_link_bytes("all-reduce", 1024, 1) == 0
    with pytest.raises(ValueError):
        hlo.ring_link_bytes("broadcast", 1024, 4)


def test_counter_tracks_live_bytes_and_refuses_real_tensors():
    def fn():
        a = torch.empty(1000, device="meta")          # 4000 bytes
        b = a.view(10, 100)                           # a view: no bytes
        c = torch.zeros(500, device="meta")           # 2000 bytes
        del a
        d = b.exp()                                   # 4000 bytes
        del b                                         # frees a's storage
        return c, d
    r, (c, d) = hlo.analyze(fn)
    assert r["peak_bytes"] == 10000 and r["end_bytes"] == 6000
    assert r["transcendentals"] == 1000 and r["hbm_bytes"] == 2000 + 8000
    with pytest.raises(ValueError, match="meta tensors only"):
        hlo.analyze(lambda: torch.ones(3) + 1)


def _weights(cfg):
    D, q, kv, F = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return cfg.num_layers * (D * q + 2 * D * kv + q * D + 3 * D * F)


def test_dryrun_product_flops_written_out():
    """Reduced qwen2.5-14b standing for the card, B = 2, S = 16 (T = 32
    tokens): the products (the reference's dots; attention runs in the
    counted kernel) are the dense weights' 2 T W, and the head's at the
    last position. Training: forward, the backward's recompute and two
    backward products per weight, 8 T (W + D V), less each unit's last
    product, whose output no backward reads, so the recompute stops before
    it. Decode: the weights and the head once per row as products, and
    each layer's two attention products over the 16-position cache in the
    counted ``decode_attention`` kernel."""
    cfg = reduced(get_config("qwen2.5-14b"))
    B, S, T = 2, 16, 32
    D, V, W = cfg.d_model, cfg.vocab_size, _weights(cfg)
    pre = dryrun.count_step(cfg, "prefill", B, S)
    assert pre["product_flops"] == 2 * T * W + 2 * B * D * V
    assert pre["kernels"] == {"flash_attention": cfg.num_layers}
    train = dryrun.count_step(cfg, "train", B, S)
    last = cfg.num_units * 2 * T * cfg.d_ff * D
    assert train["product_flops"] == 8 * T * (W + D * V) - last
    assert train["kernels"] == {"flash_attention": 2 * cfg.num_layers,
                                "flash_attention_bwd": cfg.num_layers}
    dec = dryrun.count_step(cfg, "decode", B, S)
    attn = cfg.num_layers * 2 * 2 * B * cfg.n_heads * S * cfg.resolved_head_dim
    assert dec["product_flops"] == 2 * B * (W + D * V)
    assert dec["kernel_flops"] == attn
    assert dec["product_flops"] + dec["kernel_flops"] \
        == 2 * B * (W + D * V) + attn
    assert dec["kernels"] == {"decode_attention": cfg.num_layers}


def test_counted_kernels_use_the_bound_formulas():
    """Each kernel counted on meta reports ``chip_smoke.py``'s bound work:
    one RG-LRU layer's lru_scan and the local attention's flash_attention
    at the recurrentgemma prefill shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as lru
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3)
    c = dryrun.count_step(cfg, "prefill", 8, 4096)
    assert c["kernels"] == {"lru_scan": 2, "flash_attention": 1}
    scan = lru.work(8, 4096, 2560)
    att = fa.work(8, 10, 1, 4096, 256, 2, 2048)
    assert c["kernel_flops"] == 2 * scan["flops"] + att["flops"]
    assert c["kernel_bytes"] == 2 * scan["hbm_bytes"] + att["hbm_bytes"]
    assert att["flops"] == 4 * 256 * 8 * 10 * (2048 * 2049 // 2
                                                + 2048 * 2048)


def test_counting_allocates_nothing():
    """A full-size cell (qwen1.5-110b's 32k prefill: 207 GiB of weights
    and 484 GiB at its peak, counted, its SwiGLU over groups of
    ``FFN_TOKENS`` tokens) runs on meta tensors: the host's resident
    memory grows by far less than one layer's weights."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    c = dryrun.count_step(get_config("qwen1.5-110b"), "prefill", 32, 32768)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert c["argument_bytes"] > 200 * 2**30 \
        and c["peak_bytes"] > 450 * 2**30
    assert grown < 1 << 20          # KiB: under 1 GiB


def test_dryrun_cells_roofline_and_report(tmp_path, monkeypatch):
    """run_cell on each mesh for one cell; the roofline and the report
    read the records back; a cell over the card reports the depth that
    fits."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    arch, shape = "recurrentgemma-2b", "decode_32k"
    cfg = all_configs()[arch]
    cell = SHAPES[shape]
    counts = dryrun.count_step(cfg, cell.kind, cell.global_batch,
                               cell.seq_len)
    recs = {m: dryrun.run_cell(arch, shape, m, counts=counts)
            for m in dryrun.MESHES}
    for m, rec in recs.items():
        (tmp_path / f"{arch}__{shape}__{m}.json").write_text(json.dumps(rec))
    assert recs["single"]["devices"] == 256 and recs["multi"]["devices"] == 512
    assert recs["local"]["cost"]["flops"] == 256 * recs["single"]["cost"][
        "flops"]
    # the specs hold the position as an int32 scalar; the counted step
    # takes it as a Python int
    assert recs["local"]["memory"]["argument_bytes"] == counts[
        "argument_bytes"] + 4
    assert recs["single"]["memory"]["argument_bytes"] < counts[
        "argument_bytes"] / 16
    assert recs["local"]["memory"]["fits"] is True
    rows = roofline.full_table(tmp_path, "local")
    assert len(rows) == 1 and rows[0]["dominant"] == "memory"
    text = report.dryrun_table("local", tmp_path)
    assert arch in text and "| yes" in text
    big = dryrun.run_cell("qwen2.5-14b", "decode_32k", "local")
    fit = big["memory"]
    assert fit["fits"] is False and 0 < fit["depth_that_fits"] < 48
    assert "cut its depth" in fit["message"]
    assert not dryrun.cell_applicable(all_configs()["qwen2.5-14b"],
                                      "long_500k")


def test_variant_rows_read_tagged_records(tmp_path):
    """report.variant_rows, the reference's perf-variant table, from two
    single-pod records written to ``tmp_path``: the baseline (no tag) and
    a ``--tag`` run's, here the baseline with its counted flops and bytes
    scaled; a tag without a record is left out. Each row's terms are the
    record's roofline."""
    arch, shape = "recurrentgemma-2b", "decode_32k"
    cfg = all_configs()[arch]
    cell = SHAPES[shape]
    counts = dryrun.count_step(cfg, cell.kind, cell.global_batch,
                               cell.seq_len)
    base = dryrun.run_cell(arch, shape, "single", counts=counts)
    tagged = dict(base, tag="x4", overrides={},
                  cost={k: 4 * v for k, v in base["cost"].items()})
    (tmp_path / f"{arch}__{shape}__single.json").write_text(json.dumps(base))
    (tmp_path / f"{arch}__{shape}__single__x4.json").write_text(
        json.dumps(tagged))
    text = report.variant_rows([(arch, shape, ""), (arch, shape, "x4"),
                                (arch, shape, "absent")], tmp_path)
    lines = text.splitlines()
    assert lines[0] == ("| cell | variant | compute s | memory s | "
                        "collective s | dominant | roofline frac |")
    assert len(lines) == 4
    for line, rec, tag in ((lines[2], base, "baseline"),
                           (lines[3], tagged, "x4")):
        r = roofline.roofline_row(rec)
        assert line == (f"| {arch} {shape} | {tag} | {r['compute_s']:.2f} "
                        f"| {r['memory_s']:.2f} | {r['collective_s']:.2f} "
                        f"| {r['dominant']} | {r['roofline_fraction']:.3f} |")
    b, t = (roofline.roofline_row(r) for r in (base, tagged))
    assert t["memory_s"] == pytest.approx(4 * b["memory_s"])
    assert t["roofline_fraction"] == pytest.approx(
        b["roofline_fraction"] / 4)


def test_variant_rows_equal_the_reference(tmp_path, monkeypatch):
    """report.variant_rows against the reference's
    (``repro/analysis/report.py:42``) on the same counts: the reference's
    ``analyze`` returns each record's flops, bytes and link bytes in
    place of its HLO text's, its rates are the port's (one card's bf16
    tensor-core peak, HBM, NVLink), and a placeholder ``.hlo.txt`` lies
    beside each record. The records, each cell's counts scaled by 100 so
    the terms show at two decimals: the counted prefill_32k baseline, a
    tag with all its flops on the tensor cores and link bytes that make
    the collective term dominant, and decode_32k. The table is the
    reference's, column for column, but for one known difference: where
    a record counts float32 flops off the tensor cores, the port's
    compute term charges them at the float32 rate (``compute_seconds``)
    and the reference's charges every flop at one peak, so there the
    port's compute column is at least the reference's and its other
    columns equal."""
    from repro.analysis import report as rreport

    arch = "recurrentgemma-2b"
    cfg = all_configs()[arch]
    recs = {}
    for shape in ("prefill_32k", "decode_32k"):
        cell = SHAPES[shape]
        base = dryrun.run_cell(arch, shape, "single", counts=dryrun.count_step(
            cfg, cell.kind, cell.global_batch, cell.seq_len))
        recs[shape, ""] = dict(base, cost={k: 100 * v for k, v in
                                           base["cost"].items()})
    cost = recs["prefill_32k", ""]["cost"]
    recs["prefill_32k", "tc"] = dict(
        recs["prefill_32k", ""], tag="tc", overrides={},
        cost=dict(cost, tensor_core_flops=cost["flops"]),
        collective_link_bytes=2e12)
    counts = {}
    for (shape, tag), rec in recs.items():
        stem = f"{arch}__{shape}__single" + (f"__{tag}" if tag else "")
        (tmp_path / f"{stem}.json").write_text(json.dumps(rec))
        (tmp_path / f"{stem}.hlo.txt").write_text(stem)
        counts[stem] = {"flops": rec["cost"]["flops"],
                        "hbm_bytes": rec["cost"]["bytes_accessed"],
                        "collective_link_bytes": rec.get(
                            "collective_link_bytes", 0.0)}
    monkeypatch.setattr(rreport, "RD", tmp_path)
    monkeypatch.setattr(rreport, "analyze",
                        lambda text, default_group: counts[text])
    monkeypatch.setattr(rreport, "PEAK_FLOPS", roofline.BF16_TC_FLOPS)
    monkeypatch.setattr(rreport, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(rreport, "ICI_BW", roofline.LINK_BW)
    tags = [(arch, shape, tag) for shape, tag in recs] + [
        (arch, "prefill_32k", "absent")]
    got = report.variant_rows(tags, tmp_path).splitlines()
    want = rreport.variant_rows(tags).splitlines()
    assert len(got) == len(want) == 2 + len(recs)
    assert got[:2] == want[:2]
    dominant = set()
    for g, w, rec in zip(got[2:], want[2:], recs.values(), strict=True):
        gc, wc = g.split("|"), w.split("|")
        dominant.add(gc[6].strip())
        if rec["cost"]["tensor_core_flops"] == rec["cost"]["flops"]:
            assert g == w
        else:
            assert gc[:3] + gc[4:] == wc[:3] + wc[4:]
            assert float(gc[3]) >= float(wc[3])
    assert dominant == {"memory", "collective"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_phase12_prediction_rehearses_on_cpu(monkeypatch):
    """Phase 12b on the host with stand-in measurements: a peak within
    PEAK_RTOL passes, one 10 % off fails."""
    cs = _chip_smoke()
    pred = cs.predict_against_card(torch, {
        "prefill": {"peak_bytes": 9.867 * 2**30, "left_bytes": 0, "s": 0.6},
        "train": {"peak_bytes": 55.446 * 2**30, "left_bytes": 0, "s": 0.85}})
    assert pred["prefill"]["dominant"] == "memory"
    assert abs(pred["train"]["peak_rel_err"]) < 1e-3
    with pytest.raises(cs.SmokeFailure, match="predicted peak"):
        cs.predict_against_card(torch, {
            "prefill": {"peak_bytes": 11 * 2**30, "left_bytes": 0, "s": 0.6},
            "train": {"peak_bytes": 55.446 * 2**30, "left_bytes": 0,
                      "s": 0.85}})
