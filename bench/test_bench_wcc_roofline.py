"""CPU tests of ``wcc_round_roofline.timeline``'s reader and of
``bench/roofline/wcc_round.py``: a synthetic traced run (the program's
``Compute.wcc`` spans, recorded under a CPU profiler, and a trace's
``kernels`` summary written by hand) read to the share it implies."""
from __future__ import annotations

import pathlib
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import manifest as mf  # noqa: E402
from benchlib.roofline import bound_s, load_count  # noqa: E402

from repro_torch import trace  # noqa: E402

KERNEL = ("void (anonymous namespace)::wcc_round_kernel<true>(int const*, "
          "int const*, long long, int const*, int*, long long, int*)")
OTHER = "void (anonymous namespace)::segment_sum_f1_kernel<float>(...)"
# (m, n, rounds) of each WCC call in the synthetic window
CALLS = ((16_777_216, 1_048_576, 7), (16_000_000, 1_048_576, 6),
         (1000, 100, 0))


def _run(kernels: dict):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.monotonic()
        for m, n, rounds in CALLS:
            with trace.span("Compute.wcc", m=m, n=n, route="kernel") as sp:
                sp.set(rounds=rounds)
        t1 = time.monotonic()
    return types.SimpleNamespace(trace={"t0": t0, "t1": t1,
                                        "kernels": kernels})


def test_reader_reads_launches_against_the_rounds_mean_bound():
    launches, seconds = 13, 13 * 150e-6
    run = _run({KERNEL: [launches, seconds], OTHER: [9, 1e-3]})
    try:
        got = mf.reader("wcc_round_roofline.timeline")(run)
    finally:
        trace.clear()
    count = load_count("wcc_round")
    bounds = [r * bound_s(count, {"m": m, "n": n}) for m, n, r in CALLS]
    want = 100.0 * launches * (sum(bounds) / 13) / seconds
    assert got == pytest.approx(want, rel=1e-12)
    # about 42.6 us of bound over 150 us a launch
    assert 27 < got < 29


@pytest.mark.parametrize("kernels", [{OTHER: [9, 1e-3]}, {KERNEL: [0, 0.0]}])
def test_reader_reads_none_without_the_kernel(kernels):
    run = _run(kernels)
    try:
        assert mf.reader("wcc_round_roofline.timeline")(run) is None
        run.trace = None
        assert mf.reader("wcc_round_roofline.timeline")(run) is None
    finally:
        trace.clear()


def test_count_at_the_timeline_shape():
    count = load_count("wcc_round")
    shape = {"m": 16_777_216, "n": 1_048_576}
    assert count.bytes_moved(**shape) == 142_606_336
    assert count.flops(**shape) == 0
    assert f"{bound_s(count, shape) * 1e3:.4f}" == "0.0426"
    assert count.KERNEL_NAMES == ("wcc_round_kernel",)
    assert not any("segment_sum" in k for k in count.KERNEL_NAMES)
