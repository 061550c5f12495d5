"""CUDA wrapper: one round of WCC's min-label propagation.

The kernel is in ``csrc/wcc_round.cu``: one launch, one pass over the edge
list, after the C entry has copied the labels to the output and zeroed the
flag (the file's header says what bounds it on an H100 and what its design
does about hubs and the L2). The plain version is in
:mod:`repro_torch.kernels.ref`.

The wrapper takes CUDA tensors only, checks dtypes, shapes, contiguity,
the device and that no buffer it writes overlaps another, launches on
PyTorch's current stream, raises on a launch error, and adds one to
``wcc_round.launches`` per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def _int32_vector(t: torch.Tensor, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected 1-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() < b.data_ptr() + b.nbytes
            and b.data_ptr() < a.data_ptr() + a.nbytes)


def wcc_round(src: torch.Tensor, dst: torch.Tensor, labels: torch.Tensor,
              out: torch.Tensor, changed: torch.Tensor) -> None:
    """src, dst: (m,) int32 edge endpoints in [0, n), any order (dst-sorted
    is fastest); labels, out: (n,) int32; changed: (1,) int32. Writes the
    labels after one synchronous round into ``out`` (for every vertex v the
    least of its label and its neighbours' in either direction) and 1 into
    ``changed`` if any label fell, else 0. ``out`` and ``changed`` may not
    overlap each other or any input."""
    buffers = {"src": src, "dst": dst, "labels": labels, "out": out,
               "changed": changed}
    for name, t in buffers.items():
        _int32_vector(t, name)
    if src.shape != dst.shape:
        raise ValueError(f"src and dst differ in length: {src.shape[0]} "
                         f"and {dst.shape[0]}")
    if out.shape != labels.shape:
        raise ValueError(f"out has {out.shape[0]} labels, labels "
                         f"{labels.shape[0]}")
    if changed.shape[0] != 1:
        raise ValueError(f"changed: expected 1 element, got "
                         f"{changed.shape[0]}")
    for written in ("out", "changed"):
        for name, t in buffers.items():
            if name != written and _overlap(buffers[written], t):
                raise ValueError(f"{written} overlaps {name}: the round reads "
                                 "only its input labels, so it writes "
                                 "separate buffers")
    devices = {t.device for t in buffers.values()}
    if len(devices) != 1 or labels.device.type != "cuda":
        raise ValueError("wcc_round: expected CUDA tensors on one device, "
                         f"got {sorted(map(str, devices))}")
    lib = _lib.load()
    with _lib.on_device(labels):
        code = lib.rt_wcc_round(src.data_ptr(), dst.data_ptr(), src.shape[0],
                                labels.data_ptr(), out.data_ptr(),
                                labels.shape[0], changed.data_ptr(),
                                _lib.stream_of(labels))
    _lib.check(code, "wcc_round")
    wcc_round.launches += 1


wcc_round.launches = 0
