"""CPU tests of ``decode_attention_roofline``'s reader and of
``bench/roofline/decode_attention.py``: a synthetic traced run (a traced
``generate`` span and a trace's ``kernels`` summary written by hand) read
to the share it implies, and the count held to ``decode_step.py``'s count
of the cache's bytes over the same steps."""
from __future__ import annotations

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import manifest as mf  # noqa: E402
from benchlib.record import Run  # noqa: E402
from benchlib.roofline import PEAKS, bound_s, load_count  # noqa: E402

CELL = "qwen2.5-14b.batch2k"
METRIC = "decode_attention_roofline"
MANIFEST = mf.load()
KERNEL = ("void (anonymous namespace)::decode_attention_kernel_mma<128>"
          "(__nv_bfloat16 const*, __nv_bfloat16 const*, ...)")
COMBINE = ("void (anonymous namespace)::decode_attention_kernel_combine"
           "<__nv_bfloat16>(float const*, __nv_bfloat16*, int, int, int, "
           "int, int)")
FLASH = "void flash_attention_wgmma_kernel<128>(...)"


def _run(kernels, traced=True) -> Run:
    """Two calls of the cell, the second traced; the trace's kernels as
    given."""
    _, cfg, tr = mf.cell(MANIFEST, CELL)
    run = Run(CELL, cfg, tr, 1, 45.0)
    run.t_open, run.t_close = 100.0, 145.0
    for i, s in enumerate((100.0, 117.0)):
        run.spans.append(("generate", s, s + 16.9, {
            "call": i + 1, "batch": 48, "prompt": 2048, "gen": 128,
            "tokens": 6144, "prefill_s": 6.0, "decode_s": 10.9,
            "traced": traced and i == 1}))
    run.trace = {"t0": 117.0, "t1": 125.0, "busy_s": 7.0, "window_s": 8.0,
                 "kernels": kernels}
    return run


def _bound_s() -> float:
    """The first 32 steps' bound by hand: 48 layers, step t over 2049 + t
    positions of 48 x 8 kv heads of 128 in bf16, plus q and the output."""
    nbytes = sum(48 * 2 * 48 * 128 * (2 * 8 * (2049 + t) + 2 * 40)
                 for t in range(32))
    return nbytes / PEAKS["hbm_bytes_per_s"]


def test_reader_reads_the_bound_over_the_kernels_time():
    seconds = 32 * 48 * 150e-6
    run = _run({KERNEL: [32 * 48, seconds], FLASH: [48, 0.39],
                "other": [10, 0.5]})
    got = mf.reader(METRIC)(run)
    assert got == pytest.approx(100.0 * _bound_s() / seconds, rel=1e-12)
    # about 121.5 us of bound over 150 us a launch
    assert 80.9 < got < 81
    # a combine launch counts with the kernel's
    run.trace["kernels"][COMBINE] = [32 * 48, 32 * 48 * 10e-6]
    assert mf.reader(METRIC)(run) == pytest.approx(
        100.0 * _bound_s() / (seconds + 32 * 48 * 10e-6), rel=1e-12)


def test_reader_leaves_dropped_launches_out_of_the_bound():
    """The profiler kept 1,200 of the 1,536 launches: their time over
    1,200 / 1,536 of the bound, the share a whole record would read."""
    run = _run({KERNEL: [1200, 1200 * 150e-6]})
    got = mf.reader(METRIC)(run)
    assert got == pytest.approx(100.0 * _bound_s() / (32 * 48 * 150e-6),
                                rel=1e-12)


@pytest.mark.parametrize("case", ["no_kernel", "zero_time", "no_trace",
                                  "no_traced_call"])
def test_reader_reads_none_without_the_kernel(case):
    run = _run({KERNEL: [0, 0.0]} if case == "zero_time"
               else {FLASH: [48, 0.39]} if case == "no_kernel"
               else {KERNEL: [10, 1e-3]},
               traced=case != "no_traced_call")
    if case == "no_trace":
        run.trace = None
    assert mf.reader(METRIC)(run) is None


def test_count_at_the_cells_shape_is_the_decode_steps_cache():
    """Over the traced steps the keys and values count is
    ``decode_step.py``'s ``cache_bytes`` (19.5 GB a step over the first
    32, 19.9 GB over all 128), and q and the output add 2 x 48 x 40 x 128
    bf16 a layer and step; bound by bytes."""
    _, cfg, _ = mf.cell(MANIFEST, CELL)
    count = load_count("decode_attention")
    step = load_count("decode_step")
    shapes = [{"b": 48, "hq": 40, "hkv": 8, "s": 2048 + t + 1, "hd": 128,
               "dtype": "bfloat16"} for t in range(32)]
    nbytes = 48 * sum(count.bytes_moved(**s) for s in shapes)
    cache = step.cache_bytes(cfg, 48, 2048, 32) * 32
    assert nbytes == cache + 48 * 32 * 2 * 2 * 48 * 40 * 128
    assert 19.48e9 < cache / 32 < 19.49e9
    assert 19.9e9 < step.cache_bytes(cfg, 48, 2048, 128) < 20.0e9
    assert 48 * sum(bound_s(count, s) for s in shapes) == pytest.approx(
        _bound_s(), rel=1e-12)
    for s in shapes:
        assert count.flops(**s) == 4 * 48 * 40 * 128 * s["s"]
        assert count.flops(**s) / PEAKS["flops_per_s"]["bfloat16"] \
            < count.bytes_moved(**s) / PEAKS["hbm_bytes_per_s"]
    assert count.bytes_moved(1, 2, 1, 5000, 64, window=1024) \
        == 2 * 64 * (2 * 1024 + 4)
    assert count.KERNEL_NAMES == ("decode_attention_kernel",)
    for name in count.KERNEL_NAMES:
        assert "flash_attention" not in name and "segment_sum" not in name


def test_manifest_entry():
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == METRIC)
    assert entry == {
        "name": METRIC, "unit": "%", "better": "higher",
        "source": "device_trace",
        "layer": "Kernels (kernels/decode_attention.py, "
                 "csrc/decode_attention.cu)",
        "moves": "gen_tok_s", "workloads": [CELL]}
    assert MANIFEST["per_layer"][-1] == entry
