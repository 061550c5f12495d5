"""WCC's round as one kernel (``kernels/wcc.py``, ``csrc/wcc_round.cu``):
the wrapper's refusals, the C binding, the plain round against the
port's WCC round by round, the route switch and the spans' route. The
tests marked ``cuda`` hold the kernel to the plain round on a card and
skip without one; this file imports no JAX, so on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_wcc_kernel.py
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.graph import compute as gc  # noqa: E402
from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels import wcc as cuda_wcc  # noqa: E402


def _edges(seed: int, n: int, m: int):
    """A random edge list in the join view's (dst, src) order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    order = np.lexsort((src, dst))
    return (torch.from_numpy(src[order].astype(np.int32)),
            torch.from_numpy(dst[order].astype(np.int32)))


def _view(src, dst, n):
    # compute.wcc reads only these fields of a JoinView
    return types.SimpleNamespace(n=n, m=int(src.shape[0]), src=src, dst=dst)


def _buffers(n=6, m=5):
    src = torch.zeros(m, dtype=torch.int32)
    dst = torch.zeros(m, dtype=torch.int32)
    labels = torch.arange(n, dtype=torch.int32)
    out = torch.empty(n, dtype=torch.int32)
    changed = torch.empty(1, dtype=torch.int32)
    return src, dst, labels, out, changed


@pytest.mark.parametrize("fault", ["cpu", "int64_ids", "lengths",
                                   "non_contiguous", "out_is_labels",
                                   "out_overlaps_labels", "flag_in_out"])
def test_wrapper_refuses_bad_buffers(fault):
    src, dst, labels, out, changed = _buffers()
    match = "CUDA tensors"
    if fault == "int64_ids":
        src, match = src.long(), "int32"
    elif fault == "lengths":
        dst, match = dst[:-1], "differ in length"
    elif fault == "non_contiguous":
        src, match = torch.zeros(10, dtype=torch.int32)[::2], "contiguous"
    elif fault == "out_is_labels":
        out, match = labels, "out overlaps labels"
    elif fault == "out_overlaps_labels":
        both = torch.arange(9, dtype=torch.int32)
        labels, out, match = both[:6], both[3:], "out overlaps labels"
    elif fault == "flag_in_out":
        changed, match = out[2:3], "out overlaps changed"
    cuda_wcc.wcc_round.launches = 0
    with pytest.raises((TypeError, ValueError), match=match):
        cuda_wcc.wcc_round(src, dst, labels, out, changed)
    assert cuda_wcc.wcc_round.launches == 0


def test_c_entry_is_declared_with_64_bit_counts():
    assert "wcc_round.cu" in _lib.SOURCES
    restype, argtypes = _lib._SIGNATURES["rt_wcc_round"]
    assert restype is ctypes.c_int
    # src, dst, m, labels_in, labels_out, n, changed, stream
    assert argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_void_p]


@pytest.mark.parametrize("seed,n,m", [(0, 50, 40), (1, 300, 200),
                                      (2, 1000, 3000), (3, 64, 0)])
def test_plain_round_is_the_ports_round(seed, n, m):
    src, dst = _edges(seed, n, m)
    view = _view(src, dst, n)
    labels = torch.arange(n, dtype=torch.int32)
    for k in range(1, 40):
        labels, flag = ops.wcc_round(src, dst, labels)
        assert flag.dtype == torch.int32 and flag.shape == (1,)
        assert torch.equal(labels, gc.wcc(view, max_rounds=k))
        if not int(flag):
            break
    assert torch.equal(labels, gc.wcc(view))


def test_plain_round_flag_says_whether_a_label_fell():
    src = torch.tensor([0, 2, 2], dtype=torch.int32)
    dst = torch.tensor([1, 1, 3], dtype=torch.int32)
    new, flag = ref.wcc_round(src, dst, torch.arange(5, dtype=torch.int32))
    # synchronous: 3 takes 2's label, not the 0 that 2 takes this round
    assert new.tolist() == [0, 0, 1, 2, 4] and int(flag) == 1
    again, flag = ref.wcc_round(src, dst, torch.tensor([0, 0, 0, 0, 4],
                                                       dtype=torch.int32))
    assert again.tolist() == [0, 0, 0, 0, 4] and int(flag) == 0


def test_kernel_route_refuses_a_cpu_view():
    src, dst = _edges(4, 20, 30)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gc.wcc(_view(src, dst, 20), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.wcc_round(src, dst, torch.arange(20, dtype=torch.int32),
                      use_kernel=True)


def test_spans_name_the_plain_route_on_the_cpu():
    src, dst = _edges(5, 500, 400)
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            labels = gc.wcc(_view(src, dst, 500))
        records = trace.spans()
    finally:
        trace.clear()
    (call,) = [s for s in records if s.name == "Compute.wcc"]
    rounds = [s for s in records if s.name == "Compute.wcc.round"]
    assert call.attrs["route"] == "plain"
    assert (call.attrs["m"], call.attrs["n"]) == (400, 500)
    assert call.attrs["rounds"] == len(rounds) > 1
    assert all(s.parent == call.id for s in rounds)
    for s in rounds:
        assert 0 <= s.attrs["wait_s"] <= s.end - s.start
    assert torch.equal(labels, gc.wcc(_view(src, dst, 500),
                                      max_rounds=len(rounds)))


# ------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,m", [(0, 1000, 5000), (1, 70_001, 300_001),
                                      (2, 100, 0)])
def test_kernel_round_is_bit_equal_to_the_plain_round(cuda_device, seed, n,
                                                      m):
    src, dst = (t.to(cuda_device) for t in _edges(seed, n, m))
    labels = torch.arange(n, dtype=torch.int32, device=cuda_device)
    for _ in range(60):
        got, flag = ops.wcc_round(src, dst, labels, use_kernel=True)
        want, want_flag = ref.wcc_round(src, dst, labels)
        assert torch.equal(got, want) and int(flag) == int(want_flag)
        if not int(flag):
            break
        labels = want
    view = _view(src, dst, n)
    assert torch.equal(gc.wcc(view), gc.wcc(view, use_kernel=False))
    # one row off its allocation: the scalar loads
    got, _ = ops.wcc_round(src[1:], dst[1:], labels, use_kernel=True)
    assert torch.equal(got, ref.wcc_round(src[1:], dst[1:], labels)[0])
