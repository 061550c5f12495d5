"""Build and bind the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have a plain C interface. At
first use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
process per source, all started together), linked into one shared library
under ``build/repro_torch/`` at the repository root, and loaded with
``ctypes``. The library's file name carries a hash of the sources, of
every header under ``csrc/`` and of the compile and link flags, so an
edited source or header rebuilds and an unchanged tree loads the library
already built. The compiler's output (``-Xptxas -v``: registers, shared
memory and spills of every kernel) is kept beside the library as
``<library>.log``. Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("snapshot_resolve.cu", "segment_sum.cu", "lru_scan.cu",
           "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu",
           "wcc_round.cu", "decode_attention.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build in this process took (None: loaded a built library
# or nothing loaded yet), for a caller to report
build_seconds: float | None = None

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (restype, argtypes)
    "rt_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    "rt_liveness_mask": (ctypes.c_int, [_P, _P, ctypes.c_int, _P,
                                        ctypes.c_longlong, _P]),
    "rt_snapshot_resolve": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int,
                                           _P, _P, ctypes.c_longlong,
                                           ctypes.c_int, _P]),
    "rt_segment_sum": (ctypes.c_int, [_P, ctypes.c_int, _P, _P,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_int, _P]),
    "rt_lru_scan": (ctypes.c_int, [_P] * 4 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * 2 + [_P]),
    "rt_lru_scan_bwd_carry": (ctypes.c_int, [_P] * 3
                              + [ctypes.c_longlong] * 3
                              + [ctypes.c_int, _P]),
    "rt_lru_scan_bwd": (ctypes.c_int, [_P] * 8 + [ctypes.c_longlong] * 3
                        + [ctypes.c_int, _P]),
    "rt_flash_attention": (ctypes.c_int, [_P] * 5 + [ctypes.c_int] * 8
                           + [ctypes.c_float, _P]),
    "rt_flash_attention_sm90": (ctypes.c_int, [_P] * 5 + [ctypes.c_int] * 7
                                + [ctypes.c_float, _P]),
    "rt_flash_attention_bwd": (ctypes.c_int, [_P] * 10 + [ctypes.c_int] * 8
                               + [ctypes.c_float, _P]),
    "rt_flash_attention_bwd_sm90": (ctypes.c_int, [_P] * 10
                                    + [ctypes.c_int] * 7
                                    + [ctypes.c_float, _P]),
    "rt_wcc_round": (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P, _P,
                                    ctypes.c_longlong, _P, _P]),
    "rt_decode_attention": (ctypes.c_int, [_P] * 6 + [ctypes.c_int] * 8
                            + [ctypes.c_float, _P]),
    "rt_decode_attention_combine": (ctypes.c_int, [_P] * 2
                                    + [ctypes.c_int] * 6 + [_P]),
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises ``RuntimeError`` when none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from src/repro_torch/csrc at first use")
    return found


def _digest(csrc: pathlib.Path = CSRC) -> str:
    """Hash of what the library is built from: the compile and link flags,
    the sources and every header under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("|",) + LINK_FLAGS).encode())
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (in parallel) and link the shared library, unless
    a library for these exact sources exists. Returns its path."""
    global build_seconds
    so = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = pathlib.Path(tmp) / (pathlib.Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for name, p in procs:
            out, _ = p.communicate()
            text = out.decode(errors="replace")
            logs.append(f"== {name}\n{text}")
            if p.returncode:
                errors.append(f"{name}:\n{text}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = pathlib.Path(tmp) / so.name
        link = subprocess.run(
            [exe, *NVCC_FLAGS, *LINK_FLAGS, "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if code:
        msg = load().rt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


def build_log() -> str:
    """What ``nvcc`` printed when it built the current library."""
    log = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.log"
    return log.read_text() if log.exists() else ""


def on_device(t: torch.Tensor):
    """``torch.cuda.device(t.device)``, or nothing when ``t`` already lies
    on the current device: the guard costs host time on every launch."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """The checks every wrapper makes before it hands a pointer to C:
    a contiguous CUDA tensor of an accepted dtype and rank."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_or_meta(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """:func:`require`, except that a meta tensor of an accepted dtype,
    rank and layout passes too: for a wrapper whose meta branch counts its
    kernel's work for the dry-run and hands no pointer on."""
    if isinstance(t, torch.Tensor) and t.is_meta:
        if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: meta tensor {t.dtype} "
                             f"{tuple(t.shape)} is not a contiguous "
                             f"{ndim}-d tensor of {tuple(dtypes)}")
        return
    require(t, name, dtypes, ndim)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if a raw launcher would drop a gradient: its output has no
    autograd history, so with grad mode on no input may require grad (the
    autograd Function in the wrapper's module is the differentiable
    entry)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad; the raw launcher would lose "
            "its gradient (call it through kernels.ops, whose autograd "
            "Function runs the backward kernel)")


def int32_scalar(q, name: str) -> int:
    q = int(q)
    if not -(1 << 31) <= q < (1 << 31):
        raise ValueError(f"{name}: {q} does not fit int32")
    return q
