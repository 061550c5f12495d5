#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero
before the result lines:

1. Device line (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``src/repro_torch/csrc``; the tensor-core attention
   kernel must build without spills (``-Xptxas -v``) and hold HGMMA
   instructions (``cuobjdump -sass``).
2. Every kernel against its plain PyTorch version on the card, at the
   serving slice's shapes: ``liveness_mask`` (16,000,000 stamps, sentinel
   and clamped query included) and ``snapshot_resolve`` (4,000,000 x 4),
   byte-equal; ``segment_sum`` at 1,000,000 x 16 bf16 (3e-2 relative), and
   on edge cases against the float64 sum (hub segments over three chunks,
   empty segments at the head, middle and tail, phantom rows, m not a
   multiple of 4, F = 3, ids and values one row off their allocations).
   Times are CUDA-event medians of 20 runs after warm-up; ``device_ms`` is
   the kernel's own time from ``torch.profiler``, ``host_ms`` the
   wrapper's host time per call.
3. The serving slice, driven as ``python -m repro_torch.launch.serve_graph``
   drives it: 1,048,576 vertices in 4 shards on the card, a 16-epoch churn
   stream of 1,000,000 adds per epoch with ``delete_frac=0.2`` (seed 0), 16
   demo queries per epoch through ``GraphQueryServer``, PageRank prewarmed
   every epoch (tol 1e-6, max_iter 200). Launch counts are reset just
   before and read just after; the snapshot-mask and segment-sum kernels
   must have run, ``segment_sum`` once per PageRank iteration. The last epoch's window is answered again with the
   plain versions on the card: k-hop, reachability and top-k byte-equal,
   PageRank within atol 1e-6. Then ``segment_sum`` at the final
   snapshot's shape (m = its live edges, n = 1,048,576, F = 1 float32,
   1e-5 relative) against its plain version and ``torch.segment_reduce``.
4. A small stream served on the card and on the CPU (the plain path the
   CPU parity tests hold against the JAX package) must agree.
5. The model-serving slice, driven as ``python -m repro_torch.launch.serve``
   drives it: full-width, full-depth ``recurrentgemma-2b`` (26 layers,
   d_model 2560, vocabulary 256,000) built on the card from
   ``torch.Generator`` seed 0; ``Server.generate`` answers 8 requests of
   4096 prompt tokens (NumPy seed 0) with 32 greedy tokens each. Launch
   counts are reset just before and read just after: ``lru_scan`` must
   have run exactly 18 times (one per RG-LRU layer) and
   ``flash_attention`` exactly 8 (one per local-attention layer), all 8 on
   its tensor-core (``wgmma``) route. Then
   each layer's mixer runs through the kernels and through the plain
   versions on the same input (the plain route's hidden state): its
   output must agree within ``MIXER_RTOL`` and each RG-LRU state within
   ``STATE_RTOL`` of their largest magnitudes, and faults planted in the
   kernel route (the window dropped, the window one kv tile short, the
   scan's ``b`` one step late) must exceed those limits. Last, the whole
   prefill runs through the kernels and through the plain versions; the
   last-position logits and every cache must agree within ``MODEL_RTOL``
   of each tensor's largest magnitude.

Phase 2 also holds the model kernels against their plain versions at the
slice's shapes: ``lru_scan`` at (8, 4096, 2560) with and without ``h0``
and at (2, 1000, 2560) (atol 1e-5, rtol 1e-4); ``flash_attention`` at
(8, 10, 1, 4096, 256) with window 2048 in bf16 (1e-2, the ``wgmma`` route)
and in float32 (2e-4, the ``simt`` route: the window edge and the tile
skipping at the serving shape), without the window in bf16 (1e-2), at
(1, 8, 2, 1024, 128) float32 (2e-4), and in bf16 at (1, 8, 2, 1000, 128)
with window 300 (ragged S, a window off the tile grid, GQA 4) and at
(2, 4, 4, 4097, 64) causal (1e-2 each).

The lines before the last are the checks off the main path's shapes as
JSON (``{"checks": [...]}``), the card, and the kernel table as JSON (one
row per kernel, at the shape its main path runs, with that run's
launches; ``route`` is the language, ``kernel_route`` which of the
wrapper's kernels ran); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense

N_VERTICES = 1 << 20
EPOCHS = 16
ADDS_PER_EPOCH = 1_000_000
SHARDS = 4
QUERIES_PER_EPOCH = 16
SEED = 0

MASK_N = 16_000_000
RESOLVE_N, RESOLVE_K = 4_000_000, 4
BF16_M, BF16_F = 1_000_000, 16

MODEL_ARCH = "recurrentgemma-2b"
MODEL_REQUESTS, MODEL_PROMPT, MODEL_GEN = 8, 4096, 32
LRU_SHAPE = (MODEL_REQUESTS, MODEL_PROMPT, 2560)
FLASH_SHAPE = (MODEL_REQUESTS, 10, 1, MODEL_PROMPT, 256)   # B, Hq, Hkv, S, hd
FLASH_WINDOW = 2048
# kernel route vs plain route on the card, relative to each tensor's
# largest magnitude: one layer's mixer on the same input (bf16 output; the
# state in float32), see check_layers_against_plain; the whole prefill,
# see check_model_against_plain
MIXER_RTOL = 1e-2
STATE_RTOL = 1e-5
MODEL_RTOL = 5e-2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time on an H100 SXM for the work, in ms, and what bounds it:
    the bytes over the memory rate or the operations over ``ops_per_s``,
    the card's peak for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, kernel: str, reps: int = 10) -> float | None:
    """The kernel's own device time per launch in ms, from ``torch.profiler``
    over ``reps`` calls of ``fn`` after a warm-up. Fails if anything else ran
    on the card in that window (every device event must be a kernel whose
    name holds ``kernel``) or if there were more launches than calls: one
    launch per call, no helper kernels, no copies. None when the profiler
    records no device activity (then the row says "not measured"). The
    profiler may drop the window's first launch, so the time is averaged
    over the launches it saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not on_card:
        return None
    others = [e.key for e in on_card if kernel not in e.key]
    check(not others, f"{kernel}: other device work in its window: {others}")
    launches = sum(e.count for e in on_card)
    check(launches <= reps, f"{kernel}: {launches} launches in {reps} calls")
    return sum(e.self_device_time_total for e in on_card) / launches / 1e3


def host_ms(torch, fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` in ms (the wrapper's checks, ctypes call
    and launch), measured without waiting for the card, then drained."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def kernel_row(name, source, replaces, *, max_abs_err, ms, plain_ms,
               nbytes, ops, library_ms, shape,
               ops_per_s: float = FP32_OPS_PER_S, kernel_route: str = "cuda",
               dev_ms=None, host=None) -> dict:
    """One row of the kernels table. ``route`` is the language (CUDA C++);
    ``kernel_route`` names which of a wrapper's kernels ran (``wgmma`` or
    ``simt`` for flash_attention, ``cuda`` where there is one kernel)."""
    b_ms, b_by = bound(nbytes, ops, ops_per_s)
    return {"name": name, "route": "cuda", "kernel_route": kernel_route,
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "device_ms": dev_ms,
            "host_ms": host, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": shape}


# --------------------------------------------------------------- phase 1
def check_tensor_core_build() -> dict:
    """The tensor-core attention kernel as built: ``-Xptxas -v`` must report
    no spills for any of its instances, and ``cuobjdump -sass`` of the
    library must show HGMMA (wgmma) instructions in each."""
    import re

    from repro_torch.kernels import _lib

    kernel = "flash_attention_wgmma_kernel"
    log = _lib.build_log()
    ptxas, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            ptxas.setdefault(name, []).append(line.strip())
    check(ptxas, f"no ptxas report for {kernel} in the build log")
    for fn, lines in ptxas.items():
        check(any("0 bytes spill stores, 0 bytes spill loads" in x
                  for x in lines), f"{fn} spills: {lines}")
    cuobjdump = pathlib.Path(_lib.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_lib.build())],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    hgmma, name = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name and "HGMMA" in line:
            hgmma[name] = hgmma.get(name, 0) + 1
    check(len(hgmma) == len(ptxas),
          f"HGMMA in {len(hgmma)} of {len(ptxas)} {kernel} instances")
    return {"ptxas": {k[-60:]: v for k, v in ptxas.items()},
            "hgmma": {k[-60:]: v for k, v in hgmma.items()}}


# --------------------------------------------------------------- phase 2
def check_stamp_kernels(torch) -> list[dict]:
    from repro_torch.core.versioned import PACK32_NEVER, Version, \
        pack32_clamped
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    dev = "cuda"
    # stamps as the store packs them: epoch << 20, deletes later than
    # creates, 60% of rows never deleted (the int32-max sentinel)
    epoch = torch.randint(0, 16, (MASK_N,), generator=g, device=dev,
                          dtype=torch.int32)
    created = epoch << 20
    deleted = (epoch + torch.randint(1, 8, (MASK_N,), generator=g,
                                     device=dev, dtype=torch.int32)) << 20
    never = torch.rand(MASK_N, generator=g, device=dev) < 0.6
    deleted[never] = PACK32_NEVER
    q_mid = pack32_clamped(Version(8, 0))
    q_clamped = pack32_clamped(Version(1 << 30, 1 << 30))
    check(q_clamped == PACK32_NEVER - 1, "clamped query is not int32 max - 1")
    for q in (q_mid, q_clamped, 0):
        got = ops.liveness_mask(created, deleted, q, use_kernel=True)
        want = ref.liveness_mask(created, deleted, q)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"liveness_mask differs from its plain version at q={q}")
    def mask():
        return ops.liveness_mask(created, deleted, q_mid, use_kernel=True)
    ms = cuda_ms(torch, mask)
    mask_dev = device_ms(torch, mask, "liveness_mask")
    plain = cuda_ms(torch, lambda: ref.liveness_mask(created, deleted, q_mid))
    rows = [kernel_row(
        "liveness_mask", "src/repro_torch/csrc/snapshot_resolve.cu",
        "src/repro/kernels/snapshot_resolve.py:78", max_abs_err=0.0,
        ms=ms, plain_ms=plain, nbytes=9 * MASK_N, ops=3 * MASK_N,
        library_ms=None, shape=f"N={MASK_N}", dev_ms=mask_dev)]
    del created, deleted, never, epoch

    # (N, K) ascending version rows, int32-max padded past a random fill
    raw = torch.randint(0, 1 << 24, (RESOLVE_N, RESOLVE_K), generator=g,
                        device=dev, dtype=torch.int32)
    versions = torch.sort(raw, dim=1).values
    fill = torch.randint(0, RESOLVE_K + 1, (RESOLVE_N, 1), generator=g,
                         device=dev)
    slot = torch.arange(RESOLVE_K, device=dev)[None, :]
    versions = torch.where(slot < fill, versions,
                           torch.full_like(versions, PACK32_NEVER))
    values = torch.randn(RESOLVE_N, RESOLVE_K, generator=g, device=dev)
    q = 1 << 23
    got_v, got_i = ops.snapshot_resolve(versions, values, q, use_kernel=True)
    want_v, want_i = ref.snapshot_resolve(versions, values, q)
    torch.cuda.synchronize()
    check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
          "snapshot_resolve differs from its plain version")
    resolved = int((want_i >= 0).sum())
    def resolve():
        return ops.snapshot_resolve(versions, values, q, use_kernel=True)
    ms = cuda_ms(torch, resolve)
    resolve_dev = device_ms(torch, resolve, "snapshot_resolve")
    plain = cuda_ms(torch, lambda: ref.snapshot_resolve(versions, values, q))
    # versions read once, one value per resolved item, value + index out
    nbytes = RESOLVE_N * RESOLVE_K * 4 + resolved * 4 + RESOLVE_N * 8
    rows.append(kernel_row(
        "snapshot_resolve", "src/repro_torch/csrc/snapshot_resolve.cu",
        "src/repro/kernels/snapshot_resolve.py:39", max_abs_err=0.0,
        ms=ms, plain_ms=plain, nbytes=nbytes,
        ops=RESOLVE_N * RESOLVE_K, library_ms=None,
        shape=f"N={RESOLVE_N},K={RESOLVE_K},float32", dev_ms=resolve_dev))
    return rows


def check_segment_sum(torch, name, values, ids, n, rtol) -> dict:
    """Kernel vs plain version (and torch.segment_reduce, timed only)."""
    from repro_torch.kernels import ops, ref

    got = ops.segment_sum(values, ids, n, use_kernel=True)
    want = ref.segment_sum(values, ids, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= rtol * max(scale, 1e-30),
          f"{name}: max |kernel - plain| {err} exceeds {rtol} x {scale}")
    def kernel():
        return ops.segment_sum(values, ids, n, use_kernel=True)
    ms = cuda_ms(torch, kernel)
    dev = device_ms(torch, kernel, "segment_sum")
    host = host_ms(torch, kernel)
    plain = cuda_ms(torch, lambda: ref.segment_sum(values, ids, n))
    valid = int(((ids >= 0) & (ids < n)).sum())
    lengths = torch.bincount(ids[:valid].long(), minlength=n)
    data = values[:valid]
    library = cuda_ms(torch, lambda: torch.segment_reduce(
        data, "sum", lengths=lengths, axis=0))
    m, f = values.shape
    nbytes = m * f * values.element_size() + m * 4 + n * f * 4
    return kernel_row(
        name, "src/repro_torch/csrc/segment_sum.cu",
        "src/repro/kernels/segment_sum.py:50", max_abs_err=err, ms=ms,
        plain_ms=plain, nbytes=nbytes, ops=valid * f, library_ms=library,
        shape=f"m={m},n={n},F={f},{str(values.dtype).split('.')[-1]}",
        dev_ms=dev, host=host)


def segment_sum_edge_cases(np, rng):
    """(name, ids, values, n) that pin the one-pass kernel's ownership rule
    (float32 values, float64 for the exact sum): hub segments longer than
    three 2,048-row chunks, empty segments at the head, the middle and the
    tail, rows in the phantom segment n, m not a multiple of 4, and F > 1."""
    n = 1000
    ids = np.concatenate([
        np.full(3, 7),                    # ids 0-6 empty: the head
        np.full(13_001, 8),               # a hub over four chunks
        np.repeat(np.arange(9, 300), 5),  # short segments
        np.full(20_000, 310),             # ids 300-309 empty; another hub
        np.arange(320, 900, 2),           # every other id empty
        np.full(37, n),                   # the phantom segment
    ]).astype(np.int32)                   # ids 899-999 empty: the tail
    assert len(ids) % 4 != 0
    cases = []
    for f in (1, 3):
        vals = rng.standard_normal((len(ids), f))
        cases.append((f"edges F={f}", ids, vals, n))
    sparse = np.sort(rng.choice(50_000, 9_999, replace=False)).astype(np.int32)
    cases.append(("sparse ids, n past the last id", sparse,
                  rng.standard_normal((len(sparse), 1)), 60_000))
    return cases


def check_segment_sum_edges(torch) -> list[dict]:
    """The edge cases against the float64 sum on the card, within 1e-5 +
    8 x 2^-24 of each segment's absolute mass (both float32 sums round at
    up to 2^-24 of that mass per add, see tests/test_torch_cuda.py), for
    aligned inputs and for ids and values one row off their allocations
    (16-byte loads then start mid-line). Returns one check per case."""
    import numpy as np

    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 4)

    def one_row_off(t):
        """The same values in a view one row past its allocation's start."""
        return torch.cat([t[:1], t])[1:]

    out = []
    for name, ids, vals, n in segment_sum_edge_cases(np, rng):
        m, f = vals.shape
        ids_t = torch.from_numpy(ids).cuda()
        vals_t = torch.from_numpy(vals.astype(np.float32)).cuda()
        keep = (ids_t >= 0) & (ids_t < n)
        exact, mass = (torch.zeros((n, f), dtype=torch.float64, device="cuda")
                       .index_add_(0, ids_t[keep].long(), x[keep])
                       for x in (vals_t.double(), vals_t.double().abs()))
        limit = 1e-5 + 8 * 2.0 ** -24 * mass
        for off_ids, off_vals in ((0, 0), (1, 1), (0, 1), (1, 0)):
            i = one_row_off(ids_t) if off_ids else ids_t
            v = one_row_off(vals_t) if off_vals else vals_t
            got = ops.segment_sum(v, i, n, use_kernel=True)
            torch.cuda.synchronize()
            err = (got.double() - exact).abs()
            check(got.shape == (n, f) and bool((err <= limit).all()),
                  f"segment_sum {name} (ids offset {off_ids}, values offset "
                  f"{off_vals} rows): max error {float(err.max())}")
            out.append({"name": "segment_sum", "case": name,
                        "ids_offset_rows": off_ids,
                        "values_offset_rows": off_vals, "m": m, "n": n,
                        "F": f, "max_abs_err": float(err.max())})
    return out


def check_segment_sum_bf16(torch) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    n = N_VERTICES
    # ascending ids over [0, n], the last ones in the phantom segment n
    ids = torch.sort(torch.randint(0, n + 1, (BF16_M,), generator=g,
                                   device="cuda")).values.to(torch.int32)
    values = torch.randn(BF16_M, BF16_F, generator=g, device="cuda") \
        .to(torch.bfloat16)
    return check_segment_sum(torch, "segment_sum", values, ids, n, 3e-2)


def check_lru_scan(torch) -> dict:
    """lru_scan against its plain version at the RG-LRU prefill's shape
    (with and without h0) and at a ragged S; one row, the slice's shape."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    errs = {}
    for shape, with_h0 in ((LRU_SHAPE, False), (LRU_SHAPE, True),
                           ((2, 1000, LRU_SHAPE[2]), False)):
        a = 0.5 + 0.499 * torch.rand(shape, generator=g, device="cuda")
        b = torch.randn(shape, generator=g, device="cuda")
        h0 = (torch.randn((shape[0], shape[2]), generator=g, device="cuda")
              if with_h0 else None)
        got = ops.lru_scan(a, b, h0, use_kernel=True)
        want = ref.lru_scan(a, b, h0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"lru_scan {shape}: non-finite")
        check(bool(torch.allclose(got, want, atol=1e-5, rtol=1e-4)),
              f"lru_scan {shape} h0={with_h0}: max |kernel - plain| {err}")
        errs[(shape, with_h0)] = err
        if shape == LRU_SHAPE and not with_h0:
            ms = cuda_ms(torch, lambda: ops.lru_scan(a, b, use_kernel=True))
            dev = device_ms(torch, lambda: ops.lru_scan(a, b, use_kernel=True),
                            "lru_scan")
            plain = cuda_ms(torch, lambda: ref.lru_scan(a, b), reps=5,
                            warmup=1)
            row_err = err
        del a, b, h0, got, want
    log(f"phase 2 lru_scan max |kernel - plain|: {errs}")
    B, S, C = LRU_SHAPE
    n = B * S * C
    return kernel_row(
        "lru_scan", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52", max_abs_err=row_err, ms=ms,
        plain_ms=plain, nbytes=12 * n, ops=2 * n, library_ms=None,
        shape=f"B={B},S={S},C={C},float32", dev_ms=dev)


def causal_pairs(S: int, window) -> int:
    """(q, k) pairs with 0 <= q - k < window (window None: q - k >= 0)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


FLASH_SOURCES = {"wgmma": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                            "flash_attention_wgmma_kernel"),
                 "simt": ("src/repro_torch/csrc/flash_attention.cu",
                          "flash_attention_kernel")}


def check_flash_attention(torch) -> tuple[dict, list[dict]]:
    """flash_attention against its plain version (the full S x S softmax in
    float32) and timed beside scaled_dot_product_attention with the same
    mask. Returns the row at the main path's shape (bf16, window 2048) and
    the rows of the other cases. Each case must launch the route that
    ``route(dtype, hd)`` names: bf16 at hd 64-256 the tensor-core kernel
    (``wgmma``, P rounded to bf16 before the product with v, so 1e-2), the
    float32 cases the CUDA-core kernel (``simt``, float32 throughout, so
    2e-4; at the serving shape it pins the window edge and the kv-tile
    skipping). The bf16 edge cases: a ragged S with a window that is not a
    multiple of the tile and GQA 4, and S = 4097, one row past a tile."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    rows = []
    cases = ((FLASH_SHAPE, torch.bfloat16, FLASH_WINDOW, 1e-2),
             (FLASH_SHAPE, torch.float32, FLASH_WINDOW, 2e-4),
             (FLASH_SHAPE, torch.bfloat16, None, 1e-2),
             ((1, 8, 2, 1024, 128), torch.float32, None, 2e-4),
             ((1, 8, 2, 1000, 128), torch.bfloat16, 300, 1e-2),
             ((2, 4, 4, 4097, 64), torch.bfloat16, None, 1e-2))
    for (B, Hq, Hkv, S, hd), dtype, window, tol in cases:
        q = torch.randn((B, Hq, S, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, Hkv, S, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Hkv, S, hd), generator=g, device="cuda").to(dtype)
        which = fa.route(dtype, hd)
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, window=window, use_kernel=True)
        want = ref.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        check(ops.route_counts()["flash_attention"][which] == 1,
              f"flash_attention {tuple(q.shape)} {dtype}: did not launch the "
              f"{which} route ({ops.route_counts()})")
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == dtype and bool(torch.isfinite(got).all()),
              f"flash_attention {tuple(q.shape)}: dtype or non-finite")
        check(bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"flash_attention {tuple(q.shape)} window={window}: max "
              f"|kernel - plain| {err} over {tol}")
        del want

        def kernel():
            return ops.flash_attention(q, k, v, window=window,
                                       use_kernel=True)
        source, name = FLASH_SOURCES[which]
        ms = cuda_ms(torch, kernel, reps=10)
        dev = device_ms(torch, kernel, name, reps=5)
        host = host_ms(torch, kernel, reps=20)
        plain = cuda_ms(torch, lambda: ref.flash_attention(
            q, k, v, window=window), reps=5, warmup=1)
        # the library yardstick: SDPA over kv heads expanded to Hq, with
        # the same boolean mask (timed only; the port never calls it)
        ke = k.repeat_interleave(Hq // Hkv, dim=1)
        ve = v.repeat_interleave(Hq // Hkv, dim=1)
        pos = torch.arange(S, device="cuda")
        if window is None:
            library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, ke, ve, is_causal=True), reps=10)
        else:
            d = pos[:, None] - pos[None, :]
            mask = (d >= 0) & (d < window)
            library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask), reps=10)
        pairs = B * Hq * causal_pairs(S, window)
        esize = q.element_size()
        nbytes = esize * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)
        rows.append(kernel_row(
            "flash_attention", source,
            "src/repro/kernels/flash_attention.py:78", max_abs_err=err,
            ms=ms, plain_ms=plain, nbytes=nbytes, ops=4 * hd * pairs,
            library_ms=library,
            shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},hd={hd},"
                  f"{str(dtype).split('.')[-1]},window={window}",
            ops_per_s=BF16_TC_OPS_PER_S if dtype == torch.bfloat16
            else FP32_OPS_PER_S, kernel_route=which, dev_ms=dev, host=host))
        del q, k, v, ke, ve, got
    return rows[0], rows[1:]


# --------------------------------------------------------------- phase 3
def serve_stream(torch, device: str, n: int, epochs: int, adds: int, *,
                 on_last_window=None) -> dict:
    """The serving loop of ``repro_torch.launch.serve_graph.main`` on
    ``device``; returns the answers of every window and the server."""
    import numpy as np

    from repro_torch.graph.dyngraph import synthesize_churn_stream
    from repro_torch.graph.sharded import ShardedDynamicGraph
    from repro_torch.launch.serve_graph import GraphQueryServer, _demo_queries

    t0 = time.perf_counter()
    batches = synthesize_churn_stream(n, epochs, adds, seed=SEED,
                                      delete_frac=0.2)
    t_stream = time.perf_counter() - t0
    e_max = sum(len(b.add_src) for b in batches) + 16
    sg = ShardedDynamicGraph(SHARDS, n, e_max, device=device)
    server = GraphQueryServer(sg, prewarm_pagerank=True, tol=1e-6,
                              max_iter=200)
    rng = np.random.default_rng(SEED + 1)
    windows = []
    step_s, window_s = [], []
    try:
        for i, batch in enumerate(batches):
            last = i == len(batches) - 1
            base = None
            if last and on_last_window is not None:
                # the ranks the server warm-starts the last epoch from
                prev = sg.join_view(sg.latest_sealed())
                base = server.engine.pagerank(prev)
            t = time.perf_counter()
            server.step(batch)
            if device != "cpu":
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            qs = _demo_queries(rng, n, QUERIES_PER_EPOCH)
            for q in qs:
                server.submit(q)
            t = time.perf_counter()
            pairs = server.run_window()
            window_s.append(time.perf_counter() - t)
            check(len(pairs) == len(qs),
                  f"epoch {i}: {len(pairs)} responses for {len(qs)} queries")
            for req, resp in pairs:
                check(resp.ok, f"epoch {i}: query {req.query} failed: "
                               f"{resp.error}")
                check(resp.version == batch.version,
                      f"epoch {i}: answered at {resp.version}, expected "
                      f"{batch.version}")
            windows.append([(req.query, resp.value) for req, resp in pairs])
            if last and on_last_window is not None:
                on_last_window(server, sg.join_view(batch.version), qs,
                               [resp.value for _, resp in pairs], base)
        stats = server.stats()
    finally:
        server.stop_prewarm()
        sg.shutdown()
    check(stats.seal_failures == 0, f"{stats.seal_failures} seal failures")
    check(stats.served == epochs * QUERIES_PER_EPOCH,
          f"served {stats.served} of {epochs * QUERIES_PER_EPOCH}")
    return {"windows": windows, "stats": stats, "stream_s": t_stream,
            "step_s": step_s, "window_s": window_s, "graph": sg,
            "server": server}


class counting_pagerank:
    """Within ``with``, sums the iterations of the PageRank runs that take
    the kernel route (``use_kernel`` not False): on the card each iteration
    is one ``segment_sum`` launch."""

    def __enter__(self):
        import threading

        from repro_torch.graph import compute as gc
        self.gc, self.real, self.iterations = gc, gc.pagerank, 0
        lock = threading.Lock()

        def counted(*args, **kw):
            res = self.real(*args, **kw)
            if kw.get("use_kernel") is not False:
                with lock:
                    self.iterations += res.iterations
            return res
        gc.pagerank = counted
        return self

    def __exit__(self, *exc):
        self.gc.pagerank = self.real


def same_answer(np, a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_answer(np, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def recheck_last_window(torch, checks: dict):
    """Answer the last window again with the plain versions on the card."""
    import numpy as np

    from repro_torch.device import to_host
    from repro_torch.graph import compute as gc
    from repro_torch.graph.query import PageRankQuery, SnapshotQueryEngine

    def recheck(server, view, queries, values, base):
        plain_engine = SnapshotQueryEngine(result_cache=False, tol=1e-6,
                                           max_iter=200, use_kernel=False)
        others = [(q, v) for q, v in zip(queries, values)
                  if not isinstance(q, PageRankQuery)]
        plain = plain_engine.execute(view, [q for q, _ in others])
        for (q, got), want in zip(others, plain):
            check(same_answer(np, got, want),
                  f"last window: {q} differs from the plain answer")
        served = server.engine.pagerank(view)
        ranks = gc.incremental_pagerank(base, None, view, tol=1e-6,
                                        max_iter=200, use_kernel=False)
        a, b = to_host(served.ranks), to_host(ranks.ranks)
        diff = float(np.abs(a - b).max())
        check(a.dtype == b.dtype == np.float32 and a.shape == b.shape,
              "PageRank ranks dtype/shape")
        check(bool(np.isfinite(a).all()) and abs(float(a.sum()) - 1) < 1e-3,
              "PageRank ranks not a finite distribution")
        check(diff <= 1e-6, f"PageRank kernel vs plain max diff {diff}")
        check(abs(served.iterations - ranks.iterations) <= 1,
              f"PageRank iterations {served.iterations} vs "
              f"{ranks.iterations}")
        for q, got in zip(queries, values):
            if isinstance(q, PageRankQuery):
                ids, vals = got
                check(bool(np.allclose(vals, b[ids], rtol=0, atol=1e-6)),
                      "PageRank top-k values differ from the plain ranks")
        checks.update(pagerank_max_diff=diff,
                      pagerank_iterations=[served.iterations,
                                           ranks.iterations],
                      recheck_queries=len(queries))
    return recheck


def check_small_cpu_agreement(torch) -> int:
    """A small stream served on the card and on the CPU agrees."""
    import numpy as np

    from repro_torch.graph.query import PageRankQuery

    args = (4096, 4, 4000)
    gpu = serve_stream(torch, "cuda", *args)
    cpu = serve_stream(torch, "cpu", *args)
    compared = 0
    for wg, wc in zip(gpu["windows"], cpu["windows"]):
        for (q, a), (_, b) in zip(wg, wc):
            if isinstance(q, PageRankQuery):
                check(np.allclose(a[1], b[1], rtol=0, atol=1e-6),
                      "small stream: PageRank differs between card and CPU")
            else:
                check(same_answer(np, a, b),
                      f"small stream: {q} differs between card and CPU")
            compared += 1
    return compared


# --------------------------------------------------------------- phase 5
def serve_model(torch, cfg, device: str = "cuda",
                requests: int = MODEL_REQUESTS, prompt: int = MODEL_PROMPT,
                gen: int = MODEL_GEN) -> dict:
    """``Server.generate`` on ``cfg`` (random weights from seed 0),
    counting the kernels' launches around it; each RG-LRU layer must have
    launched ``lru_scan`` once and each attention layer
    ``flash_attention`` once."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as tf

    t = time.perf_counter()
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    model = tf.init_params(cfg, g, device)
    sync(torch, device)
    init_s = time.perf_counter() - t
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (requests, prompt)).astype(np.int32)
    server = Server(cfg, model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = server.generate(prompts, gen)
    sync(torch, device)
    counts = ops.launch_counts()
    routes = ops.route_counts()["flash_attention"]
    kinds = [k for _, k in model.blocks()]
    on_card = device == "cuda"
    want = {"lru_scan": kinds.count("rglru") if on_card else 0,
            "flash_attention": len(kinds) - kinds.count("rglru")
            if on_card else 0}
    for name, n in want.items():
        check(counts[name] == n,
              f"{name} launched {counts[name]} times, expected {n}")
    # bf16 at head dim 256: every attention layer takes the tensor cores
    check(routes["wgmma"] == want["flash_attention"],
          f"flash_attention routes {routes}, expected "
          f"{want['flash_attention']} wgmma launches")
    check(out.shape == (requests, gen) and out.dtype == np.int32
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generated tokens of shape {out.shape}, dtype {out.dtype}")
    return {"cfg": cfg, "model": model, "prompts": prompts, "out": out,
            "counts": counts, "routes": routes, "init_s": init_s, "timings": server.timings,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else None),
            "params": sum(p.numel() for p in model.parameters())}


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def max_rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()),
          "non-finite values in the prefill")
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


class planted:
    """Within ``with``, the model path's ``ops`` entry point ``name`` runs
    the kernel on altered inputs: a fault the layer check must catch."""

    def __init__(self, name: str, alter):
        from repro_torch.kernels import ops
        self.ops, self.name, self.alter = ops, name, alter

    def __enter__(self):
        self.real = getattr(self.ops, self.name)

        def faulty(*args, **kw):
            args, kw = self.alter(args, kw)
            return self.real(*args, **kw)
        setattr(self.ops, self.name, faulty)

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)


def late_b(args, kw):
    """lru_scan with b_t read one step late."""
    a, b = args[:2]
    return (a, b.roll(1, 1)) + args[2:], kw


def window_to(window):
    def alter(args, kw):
        return args, {**kw, "window": window}
    return alter


def check_layers_against_plain(torch, run: dict) -> dict:
    """Each layer's mixer through the kernels (``use_kernel=None``, as the
    model path calls them) and through the plain versions, both fed the
    plain route's hidden state, so that no error carries over from the
    layers before. Both round their bf16 output once from float32 values
    that differ in the last bits (the attention's float32 sums taken in
    another order and its bf16 probabilities rounded from them; the scan's
    one FMA against a product and a sum), so the outputs may differ by one
    bf16 step (2^-8 of the largest magnitude): MIXER_RTOL allows 2.5 steps.
    The RG-LRU state is the scan's float32 output, held to STATE_RTOL. Planted faults in the first layer of each kind must
    exceed the limits."""
    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention as attn
    from repro_torch.nn import recurrent as rec
    from repro_torch.nn.layers import apply_norm

    cfg, model = run["cfg"], run["model"]
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    B, S = prompts.shape
    positions = torch.arange(S, dtype=torch.int32, device=model.device)[
        None].expand(B, S)
    window = attn.window_for("local", cfg)
    faults = {"attention": {"window dropped": window_to(None)},
              "rglru": {"b one step late": late_b}}
    tile = 64                     # the kernel's kv tile (flash_attention.cu)
    if window is not None and window > tile:
        faults["attention"]["window one kv tile short"] = window_to(
            window - tile)

    def mixer(block, kind, h, use_kernel):
        if kind == "rglru":
            return rec.rglru_forward(block.mixer, h, cfg, use_kernel,
                                     return_state=True)
        return attn.attn_forward(block.mixer, h, cfg, kind, positions,
                                 use_kernel=use_kernel), {}

    def errors(got, want):
        (yk, sk), (yp, sp) = got, want
        e = {"out": max_rel_err(torch, yk, yp)}
        e.update({f"state.{n}": max_rel_err(torch, sk[n], sp[n]) for n in sp})
        return e

    per_layer, planted_errs = [], {}
    with torch.inference_mode():
        x = tf.embed_inputs(model, cfg, prompts, positions)
        for i, (block, kind) in enumerate(model.blocks()):
            h = apply_norm(block.norm1, x, cfg.norm)
            plain = mixer(block, kind, h, False)
            e = errors(mixer(block, kind, h, None), plain)
            per_layer.append(e)
            family = "rglru" if kind == "rglru" else "attention"
            for name, alter in faults.pop(family, {}).items():
                with planted("lru_scan" if family == "rglru"
                             else "flash_attention", alter):
                    planted_errs[f"layer{i} {name}"] = errors(
                        mixer(block, kind, h, None), plain)
            x, _ = tf.apply_block(block, x, cfg, kind, positions, False)
            del h, plain
    sync(torch, model.device.type)

    def over(e):
        return [n for n, v in e.items()
                if v > (STATE_RTOL if n.startswith("state") else MIXER_RTOL)]
    for i, e in enumerate(per_layer):
        check(not over(e), f"layer {i} kernel vs plain mixer: {e} (limits "
                           f"{MIXER_RTOL}, state {STATE_RTOL})")
    missed = [n for n, e in planted_errs.items() if not over(e)]
    check(not missed, f"planted faults not caught: {missed} {planted_errs}")
    worst = {n: max(e.get(n, 0.0) for e in per_layer)
             for n in ("out", "state.h", "state.conv")}
    return {"per_layer": per_layer, "worst": worst, "planted": planted_errs}


def check_model_against_plain(torch, run: dict, gen: int = MODEL_GEN,
                              rtol: float = MODEL_RTOL) -> dict:
    """The prefill through the kernels against the same prefill through the
    plain versions, both on the card in bf16. The two routes round at other
    places (both round the attention probabilities to bf16 before the
    product with v, but from float32 sums taken in another order; the
    scan's FMA rounds once where the plain loop rounds twice); the
    differences
    enter the bf16 residual stream and grow over 26 layers, so each tensor
    is held to MODEL_RTOL of its largest magnitude."""
    from repro_torch.models import transformer as tf

    cfg, model = run["cfg"], run["model"]
    device = model.device.type
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    capacity = prompts.shape[1] + gen
    with torch.inference_mode():
        t = time.perf_counter()
        k_logits, k_cache = tf.prefill(model, cfg, prompts, capacity)
        sync(torch, device)
        kernel_s = time.perf_counter() - t
        t = time.perf_counter()
        p_logits, p_cache = tf.prefill(model, cfg, prompts, capacity,
                                       use_kernel=False)
        sync(torch, device)
        plain_s = time.perf_counter() - t
    check(tuple(k_logits.shape) == (prompts.shape[0], 1, cfg.vocab_size),
          f"logits shape {tuple(k_logits.shape)}")
    errs = {"logits": max_rel_err(torch, k_logits, p_logits)}
    layers = list(zip(tf.layer_caches(cfg, k_cache),
                      tf.layer_caches(cfg, p_cache)))
    for i, (kc, pc) in enumerate(layers):
        for name in kc:
            errs[f"layer{i}.{name}"] = max_rel_err(torch, kc[name], pc[name])
    worst = max(errs, key=errs.get)
    check(errs[worst] <= rtol,
          f"kernel prefill vs plain: {worst} off by {errs[worst]} of its "
          f"largest magnitude (limit {rtol})")
    per_layer = [max(v for k, v in errs.items()
                     if k.startswith(f"layer{i}.")) for i in range(len(layers))]
    return {"kernel_prefill_s": kernel_s, "plain_prefill_s": plain_s,
            "logits_rel_err": errs["logits"], "worst": worst,
            "worst_rel_err": errs[worst], "per_layer": per_layer}


# ------------------------------------------------------------------- main
def main() -> int:
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    from repro_torch.kernels import _lib, ops
    from repro_torch.nn.layers import strict_matmul

    # float32 products in full float32 (allow_tf32 False) and bf16 products
    # accumulated in float32 (allow_bf16_reduced_precision_reduction False),
    # as the reference's preferred_element_type=float32 asks
    strict_matmul()

    t_all = time.perf_counter()
    card = device_line()
    log(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t = time.perf_counter()
    _lib.load()
    log(f"phase 1 build: {time.perf_counter() - t:.3f} s "
        f"(nvcc {_lib.build_seconds})")
    log(f"phase 1 tensor-core kernel: {json.dumps(check_tensor_core_build())}")

    t = time.perf_counter()
    # rows: each kernel at the shape its main path runs; extra: the other
    # shapes and dtypes it is held at, off the main path
    rows = check_stamp_kernels(torch)
    extra = [check_segment_sum_bf16(torch)]
    extra.extend(check_segment_sum_edges(torch))
    rows.append(check_lru_scan(torch))
    fa_row, fa_extra = check_flash_attention(torch)
    rows.append(fa_row)
    extra.extend(fa_extra)
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    checks: dict = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with counting_pagerank() as pagerank_runs:
        run = serve_stream(torch, "cuda", N_VERTICES, EPOCHS, ADDS_PER_EPOCH,
                           on_last_window=recheck_last_window(torch, checks))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    slice_s = time.perf_counter() - t
    check(counts["liveness_mask"] > 0, "serving never launched liveness_mask")
    check(counts["segment_sum"] > 0, "serving never launched segment_sum")
    # one launch per PageRank iteration: no second pass, no helper kernel
    check(counts["segment_sum"] == pagerank_runs.iterations,
          f"segment_sum launched {counts['segment_sum']} times in "
          f"{pagerank_runs.iterations} PageRank iterations")
    st = run["stats"]
    view = run["graph"].join_view(run["graph"].latest_sealed())
    log(f"phase 3 slice: {slice_s:.3f} s (stream {run['stream_s']:.3f} s, "
        f"steps {sum(run['step_s']):.3f} s, windows "
        f"{sum(run['window_s']):.3f} s); served {st.served} queries, "
        f"p50 {st.query_p50_s * 1e3:.3f} ms, p99 {st.query_p99_s * 1e3:.3f}"
        f" ms; {pagerank_runs.iterations} PageRank iterations through the "
        f"kernels; final snapshot m={view.m}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{counts}; recheck {checks}")
    log("phase 3 per-epoch step s: "
        + " ".join(f"{x:.3f}" for x in run["step_s"]))
    log("phase 3 per-epoch window s: "
        + " ".join(f"{x:.3f}" for x in run["window_s"]))

    t = time.perf_counter()
    pr = torch.rand(N_VERTICES, device="cuda")
    contrib = (pr / torch.clamp(view.out_degree, min=1.0))[view.src]
    rows.append(check_segment_sum(torch, "segment_sum", contrib[:, None]
                                  .contiguous(), view.dst, view.n, 1e-5))
    del run, view, contrib
    compared = check_small_cpu_agreement(torch)
    log(f"phase 4 final-shape segment_sum + card/CPU agreement on "
        f"{compared} answers: {time.perf_counter() - t:.3f} s")

    from repro_torch.configs import get_config

    t = time.perf_counter()
    model_run = serve_model(torch, get_config(MODEL_ARCH))
    model_counts = model_run["counts"]
    tm = model_run["timings"]
    tokens = MODEL_REQUESTS * MODEL_GEN
    log(f"phase 5 model {MODEL_ARCH}: {model_run['params']} parameters "
        f"built in {model_run['init_s']:.3f} s; generate {MODEL_REQUESTS} x "
        f"{MODEL_PROMPT} prompt tokens + {MODEL_GEN} new: prefill "
        f"{tm['prefill_s']:.3f} s, decode {tm['decode_s'] * 1e3 / MODEL_GEN:.3f}"
        f" ms per step of one token per request ({tokens / tm['decode_s']:.1f}"
        f" tokens/s decode, "
        f"{tokens / (tm['prefill_s'] + tm['decode_s']):.1f} tokens/s "
        f"end to end); peak device memory {model_run['peak_gib']:.3f} GiB; "
        f"launches {model_counts}, flash_attention routes "
        f"{model_run['routes']}")
    t_layers = time.perf_counter()
    layers = check_layers_against_plain(torch, model_run)
    log(f"phase 5 layer by layer, kernel vs plain mixer on the same input: "
        f"worst {layers['worst']} (limits {MIXER_RTOL}, state "
        f"{STATE_RTOL}); planted faults {layers['planted']}; "
        f"{time.perf_counter() - t_layers:.3f} s")
    log("phase 5 per-layer mixer max rel err: " + " ".join(
        "/".join(f"{v:.2e}" for v in e.values()) for e in layers["per_layer"]))
    agree = check_model_against_plain(torch, model_run)
    del model_run
    torch.cuda.empty_cache()
    lru_ms = next(r["ms"] for r in rows if r["name"] == "lru_scan")
    fa_ms = next(r["ms"] for r in rows if r["name"] == "flash_attention")
    share = (model_counts["lru_scan"] * lru_ms + model_counts[
        "flash_attention"] * fa_ms) / (agree["kernel_prefill_s"] * 1e3)
    log(f"phase 5 kernel prefill {agree['kernel_prefill_s']:.3f} s (the "
        f"kernels' phase-2 times x launches: {share:.3f} of it) vs plain "
        f"prefill {agree['plain_prefill_s']:.3f} s on the card; logits "
        f"max rel err {agree['logits_rel_err']:.3e}, worst "
        f"{agree['worst']} {agree['worst_rel_err']:.3e} (limit "
        f"{MODEL_RTOL}); phase {time.perf_counter() - t:.3f} s")
    log("phase 5 per-layer cache max rel err: "
        + " ".join(f"{x:.2e}" for x in agree["per_layer"]))

    for row in rows:
        name = row["name"]
        row["launches"] = (model_counts if name in ("lru_scan",
                                                    "flash_attention")
                           else counts)[name]
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"imported {leaked[:5]}")
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"checks": extra}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
