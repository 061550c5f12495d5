#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero
before the result lines:

1. Device line (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``src/repro_torch/csrc``; the tensor-core kernels
   (the attention forward and the dK/dV and dQ kernels of its backward,
   every head-dim instance) and the forward ``lru_scan`` (every built
   (W, T) instance) must build without spills (``-Xptxas -v``), and the
   tensor-core kernels hold HGMMA instructions (``cuobjdump -sass``).
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

6. The offline graph plane, the JAX package's end-to-end example
   (``examples/dynamic_graph_end_to_end.py``) at full size on the card: a
   preferential-attachment stream (``synthesize_stream``: 1,048,576
   vertices, 8 epochs of 1,000,000 adds, seed 0), whose in-degrees follow
   a power law. Launch counts are reset just before ``pagerank_timeline``
   runs over all 8 versions (incremental, tol 1e-6, max_iter 200) and read
   just after: ``segment_sum`` once per PageRank iteration,
   ``liveness_mask`` once per view rebuilt from the stamps. The last
   ranks against the plain route within atol 1e-6; WCC and the emerging
   vertices. Then ``partition_graph(view, 16, hub_k=64)`` and the three
   modes of ``distributed_join_group_by`` against the float64 sum and
   ``compute.join_group_by`` within a derived bound (``join_bound``), with
   two planted faults that must exceed it; ``run_edge_centric`` against
   ``compute.pagerank``; ``run_pregel`` on 8,192 vertices; a MapReduce
   count of edge destinations; a dataflow's causal event delivery; the
   citation schema; a lineage-tracked analytics view recovered after a
   simulated loss; ``segment_sum`` at the power-law shape (the checks
   line).
7. The RPC tier: ``GraphRPCServer`` over a ``GraphQueryServer`` on a
   4-shard store on the card (262,144 vertices, 8 epochs of 250,000
   adds, ``delete_frac=0.2``) ingesting on a background thread while 4
   socket clients send 64 queries each over the four kinds, some pinned
   to older versions. Every answer is recomputed at its version on the
   plain path (PageRank: every kernel run again from the same start,
   within atol 1e-6); then ``partition_graph_sharded`` in both placements
   against ``compute.join_group_by``.
8. Training, driven as ``python -m repro_torch.launch.train`` drives it.
   8a: the two backward kernels against their plain versions
   (``kernels/ref.py``) on the card, each fed the same forward output:
   ``flash_attention_bwd`` at the training shape (2, 10, 1, 4096, 256)
   bf16 with window 2048, at (1, 8, 2, 1024, 128) float32, at reduced
   qwen2.5's (2, 4, 2, 64, 16) bf16 and at phase 2's bf16 edge shapes,
   each on the route ``route(dtype, hd)`` names (``wgmma`` for bf16 at hd
   64-256, bit-equal on a second call; ``simt`` otherwise);
   ``lru_scan_bwd`` (a chunked scan over time) at (2, 4096, 2560) and at
   S = 1, L - 1, L, L + 1, 4099 for its chunk length L, each with and
   without ``h0``, bit-equal on a second call; relative to each
   gradient's largest magnitude within ``BWD_RTOL_BF16``,
   ``BWD_RTOL_F32`` or ``LRU_BWD_RTOL``, with planted faults (the lse one
   row off, the window one kv tile short, the group walk one head short,
   dh one step late, one chunk's carry dropped) that must exceed them;
   timed beside the plain versions and SDPA's backward; the forward
   ``lru_scan`` timed at the training shape.
   8b: one unit (3 layers) of ``recurrentgemma-2b`` at full width, the
   loss and every parameter's gradient through the kernels against the
   plain route on the card, within ``GRAD_RTOL``, with two planted
   backward faults. 8c, the main path: ``launch.train.run`` on the full
   model (26 layers, 3.32 B float32 master weights, AdamW), 1 + 4 steps
   of 2 x 4096 Markov tokens (seed 0); launch counts reset just before
   and read just after: per step 34 ``lru_scan``, 18 ``lru_scan_bwd``, 16
   ``flash_attention`` and 8 ``flash_attention_bwd`` (all on ``wgmma``;
   the units' forward runs twice under remat); every loss finite, the first
   within ``FIRST_LOSS_TOL`` of ln(256000); step time, tokens per second,
   peak memory, then one more step taken apart (forward, loss chunks,
   backward, optimizer) with the device busy share. 8d: the driver's
   fault path on the reduced config: ``fail_at=8`` with checkpoints every
   5 steps against an uninterrupted run, the same with ``compress``, and
   the port's checkpoint served by ``launch.serve.Server.from_checkpoint``.

Phase 2 also holds the model kernels against their plain versions at the
slice's shapes: ``lru_scan`` at (8, 4096, 2560) with and without ``h0``,
at (2, 1000, 2560) and at the S edges of its segment of W warps x T steps
(1, T - 1, T, T + 1, W T - 1, W T, W T + 1, 3 W T + 5) at C = 2600, with
and without ``h0`` (atol 1e-5, rtol 1e-4), bit-equal on a second call,
with a planted fault (two halves of time split at a warp boundary, the
carry dropped) that must exceed the limit; then every built (W, T) pair
held to the same limits and timed at the serving and training shapes
(logged); ``flash_attention`` at
(8, 10, 1, 4096, 256) with window 2048 in bf16 (1e-2, the ``wgmma`` route)
and in float32 (2e-4, the ``simt`` route: the window edge and the tile
skipping at the serving shape), without the window in bf16 (1e-2), at
(1, 8, 2, 1024, 128) float32 (2e-4), and in bf16 at (1, 8, 2, 1000, 128)
with window 300 (ragged S, a window off the tile grid, GQA 4) and at
(2, 4, 4, 4097, 64) causal (1e-2 each).

The lines before the last are the checks off the main path's shapes as
JSON (``{"checks": [...]}``), the card, and the kernel table as JSON (one
row per kernel, at the shape its main path runs, with that run's
launches: phase 3 for the graph kernels, phase 5 for the forward model
kernels (``launches_training`` gives phase 8c's), phase 8c for the
backward kernels; ``route`` is the language, ``kernel_route`` which of
the wrapper's kernels ran; the forward ``lru_scan`` at the training shape
is in the checks line, with phase 8c's launches); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
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

# phase 6: the offline plane on a preferential-attachment stream
OFFLINE_N, OFFLINE_EPOCHS, OFFLINE_ADDS = 1 << 20, 8, 1_000_000
PARTS, HUB_K = 16, 64                  # benchmarks/run.py's replica axis
PREGEL_STREAM = (8192, 4, 8192)        # vertices, epochs, adds per epoch
EDGE_CENTRIC_ITERS = 40
# per-rank relative bound of the host float64 models against the float32
# PageRank on the card (about 1e-6 in a CPU rehearsal at 2^17 vertices)
EDGE_CENTRIC_RTOL = 1e-4
PREGEL_ATOL = 1e-4                     # tests/test_graph.py's tolerance
MAPREDUCE_WORDS = 1024                 # destination ids counted
F32_UNIT = 2.0 ** -24                  # float32 unit roundoff
# phase 7: the RPC tier
RPC_N, RPC_EPOCHS, RPC_ADDS = 262_144, 8, 250_000
RPC_CLIENTS, RPC_QUERIES = 4, 64
# phase 8: training recurrentgemma-2b at full width and depth
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_WARMUP, TRAIN_STEPS = 1, 4
FLASH_TRAIN_SHAPE = (TRAIN_BATCH, 10, 1, TRAIN_SEQ, 256)  # B, Hq, Hkv, S, hd
LRU_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 2560)
# backward kernel vs plain backward, relative to each gradient's largest
# magnitude: bf16 outputs round once (2^-8), so 1e-2; float32 1e-4; the
# scan's float32 chain 1e-5
BWD_RTOL_BF16, BWD_RTOL_F32, LRU_BWD_RTOL = 1e-2, 1e-4, 1e-5
# one unit's loss gradients, kernel route vs plain route on the card
GRAD_RTOL = 5e-2
# the first loss of random weights: ln(vocab) plus about half the logits'
# variance (about 1 at init), so within 1 of ln(256000)
FIRST_LOSS_TOL = 1.0


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


def device_ms(torch, fn, kernel, reps: int = 10, per_call: int = 1,
              split: dict | None = None) -> float | None:
    """The kernel's own device time per call in ms, from ``torch.profiler``
    over ``reps`` calls of ``fn`` after a warm-up. ``kernel`` is a name, or
    a tuple of names when a call launches several kernels, one of each
    (``per_call`` launches). Fails if anything else ran on the card in that
    window (every device event must be a kernel whose name holds one of the
    names) or if there were more launches than ``per_call`` per call: no
    helper kernels, no copies. Each kernel's time is averaged over the
    launches of it that the profiler saw, and a call's time is the sum of
    those averages. A window in which the profiler recorded none of a
    kernel of the call (it has dropped launches at a window's start, and
    whole windows) is profiled again, up to three windows; None
    (the row says "not measured") only when every window missed one, and
    then the log names what each window saw. ``split``, when given, gets
    each name's own time per launch."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    seen = []
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0]
        others = [e.key for e in on_card
                  if not any(n in e.key for n in names)]
        check(not others, f"{names}: other device work in its window: "
                          f"{others}")
        launches = sum(e.count for e in on_card)
        check(launches <= reps * per_call and len(on_card) <= per_call,
              f"{names}: {launches} launches of {len(on_card)} kernels in "
              f"{reps} calls")
        if len(on_card) == per_call:
            each = {n: sum(e.self_device_time_total / e.count / 1e3
                           for e in on_card if n in e.key) for n in names}
            if split is not None:
                split.update(each)
            return sum(e.self_device_time_total / e.count
                       for e in on_card) / 1e3
        seen.append([(e.key[:50], e.count) for e in on_card])
    log(f"device_ms {names}: a kernel of the call missing from every "
        f"window: {seen}")
    return None


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
TENSOR_CORE_KERNELS = ("flash_attention_wgmma_kernel", "dkv_wgmma_kernel",
                       "dq_wgmma_kernel")
# kernels whose every instance must build without spills: the tensor-core
# kernels, and the forward scan, which holds 4 T floats a thread in
# registers (each built (W, T) pair)
NO_SPILL_KERNELS = TENSOR_CORE_KERNELS + ("lru_scan_kernel",)


def check_kernel_build(no_spill=NO_SPILL_KERNELS,
                       tensor_core=TENSOR_CORE_KERNELS) -> dict:
    """The kernels as built: ``-Xptxas -v`` must report no spills for any
    instance of ``no_spill`` (the attention forward and the two kernels of
    its backward, every head-dim instance; the forward scan, every (W, T)
    instance), and ``cuobjdump -sass`` of the library must show HGMMA
    (wgmma) instructions in each instance of ``tensor_core``."""
    import re

    from repro_torch.kernels import _lib

    def ours(fn, kernels):
        return next((k for k in kernels if k in fn), None)
    log = _lib.build_log()
    ptxas, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if ours(m.group(1), no_spill) else None
        elif name and ("spill" in line or "Used" in line):
            ptxas.setdefault(name, []).append(line.strip())
    for k in no_spill:
        check(any(ours(fn, no_spill) == k for fn in ptxas),
              f"no ptxas report for {k} in the build log")
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
            name = m.group(1) if ours(m.group(1), tensor_core) else None
        elif name and "HGMMA" in line:
            hgmma[name] = hgmma.get(name, 0) + 1
    wgmma = {fn for fn in ptxas if ours(fn, tensor_core)}
    check(set(hgmma) == wgmma,
          f"HGMMA in {len(hgmma)} of {len(wgmma)} instances of "
          f"{tensor_core}: missing in {sorted(wgmma - set(hgmma))}")
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


def lru_scan_edges(warps: int, steps: int) -> tuple[int, ...]:
    """S around one warp's steps T and one segment's W T, and several
    segments and a ragged tail."""
    T, seg = steps, warps * steps
    return (1, T - 1, T, T + 1, seg - 1, seg, seg + 1, 3 * seg + 5)


def check_lru_scan(torch) -> dict:
    """lru_scan against its plain version (atol 1e-5, rtol 1e-4) at the
    RG-LRU prefill's shape (with and without h0), at a ragged S, and at
    the S edges of its segment (``lru_scan_edges``) with C = 2600 (not a
    multiple of the 32-channel tile), with and without h0; the same bits
    on a second call. A planted fault must exceed the limit: the kernel
    run on two halves of time split at a warp boundary inside a segment,
    the carry between them dropped. Returns the row at the slice's
    shape."""
    from repro_torch.kernels import lru_scan as lru
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    W, T = lru.SCAN_WARPS, lru.SCAN_STEPS

    def coeffs(shape, with_h0):
        a = 0.5 + 0.499 * torch.rand(shape, generator=g, device="cuda")
        b = torch.randn(shape, generator=g, device="cuda")
        h0 = (torch.randn((shape[0], shape[2]), generator=g, device="cuda")
              if with_h0 else None)
        return a, b, h0

    def held(got, want, what):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"lru_scan {what}: non-finite")
        check(bool(torch.allclose(got, want, atol=1e-5, rtol=1e-4)),
              f"lru_scan {what}: max |kernel - plain| {err}")
        return err

    errs = {}
    cases = [(LRU_SHAPE, False), (LRU_SHAPE, True),
             ((2, 1000, LRU_SHAPE[2]), False)]
    cases += [((2, S, LRU_SHAPE[2] + 40), with_h0)
              for S in lru_scan_edges(W, T) for with_h0 in (False, True)]
    for shape, with_h0 in cases:
        a, b, h0 = coeffs(shape, with_h0)
        got = ops.lru_scan(a, b, h0, use_kernel=True)
        want = ref.lru_scan(a, b, h0)
        err = held(got, want, f"{shape} h0={with_h0}")
        check(torch.equal(got, ops.lru_scan(a, b, h0, use_kernel=True)),
              f"lru_scan {shape} h0={with_h0}: two calls differ")
        errs[f"{shape},h0={with_h0}"] = err
        if shape == LRU_SHAPE and not with_h0:
            ms = cuda_ms(torch, lambda: ops.lru_scan(a, b, use_kernel=True))
            dev = device_ms(torch, lambda: ops.lru_scan(a, b, use_kernel=True),
                            "lru_scan")
            plain = cuda_ms(torch, lambda: ref.lru_scan(a, b), reps=5,
                            warmup=1)
            row_err = err
            # the planted fault: two halves split at a warp boundary in
            # the middle of a segment, the carry between them dropped
            S = shape[1]
            cut = S // (2 * W * T) * W * T + W // 2 * T
            halves = torch.cat([lru.lru_scan(a[:, :cut].contiguous(),
                                             b[:, :cut].contiguous()),
                                lru.lru_scan(a[:, cut:].contiguous(),
                                             b[:, cut:].contiguous())], 1)
            torch.cuda.synchronize()
            planted = float((halves - want).abs().max())
            check(not torch.allclose(halves, want, atol=1e-5, rtol=1e-4),
                  f"lru_scan: the carry dropped at step {cut} is not caught")
            del halves
        del a, b, h0, got, want
    log(f"phase 2 lru_scan (W={W}, T={T}) max |kernel - plain|: {errs}; "
        f"bit-equal on a second call; planted carry dropped: {planted}")

    B, S, C = LRU_SHAPE
    n = B * S * C
    row = kernel_row(
        "lru_scan", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52", max_abs_err=row_err, ms=ms,
        plain_ms=plain, nbytes=12 * n, ops=2 * n, library_ms=None,
        shape=f"B={B},S={S},C={C},float32", dev_ms=dev)
    row["warps"], row["steps"] = W, T
    row["planted_carry_dropped"] = planted
    row["bit_equal"] = True
    return row


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
    is one ``segment_sum`` launch. With ``record``, ``runs`` keeps each
    such run's view, keyword arguments (the warm start among them) and
    result, so that it can be run again on the plain route."""

    def __init__(self, record: bool = False):
        self.record = record

    def __enter__(self):
        import threading

        from repro_torch.graph import compute as gc
        self.gc, self.real, self.iterations = gc, gc.pagerank, 0
        self.runs = []
        lock = threading.Lock()

        def counted(view, **kw):
            res = self.real(view, **kw)
            if kw.get("use_kernel") is not False:
                with lock:
                    self.iterations += res.iterations
                    if self.record:
                        self.runs.append((view, kw, res))
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
    """Within ``with``, the model path's ``ops`` entry point ``name`` (or
    attribute ``name`` of module ``target``) runs the kernel on altered
    inputs: a fault the check must catch."""

    def __init__(self, name: str, alter, target=None):
        if target is None:
            from repro_torch.kernels import ops as target
        self.ops, self.name, self.alter = target, name, alter

    def __enter__(self):
        self.real = getattr(self.ops, self.name)

        def faulty(*args, **kw):
            args, kw = self.alter(args, kw)
            return self.real(*args, **kw)
        # a raw launcher counts on its module attribute, which is now
        # ``faulty``: carry the count there and back (the per-route counts
        # are one dict, shared)
        if hasattr(self.real, "launches"):
            faulty.launches = self.real.launches
        if hasattr(self.real, "route_launches"):
            faulty.route_launches = self.real.route_launches
        self.faulty = faulty
        setattr(self.ops, self.name, faulty)

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)
        if hasattr(self.real, "launches"):
            self.real.launches = self.faulty.launches


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


# --------------------------------------------------------------- phase 6
def join_bound(torch, src, dst, values, n: int, extra_terms: int):
    """The float64 join-group-by of ``values`` over the rows (src, dst),
    and the most a float32 computation of it may differ from it, per
    vertex: a float32 sum of k terms, added in any order, is off the
    exact sum by at most (k - 1) 2^-24 times the sum of their magnitudes
    (first order). A vertex with d in-edges summed in float32 and then
    added across ``extra_terms`` partial vectors takes k = d +
    extra_terms - 1 terms; the bound takes k = d + extra_terms, and the
    extra 2^-24 of the mass covers the float64 oracle's own rounding
    (d 2^-53 of it). Returns (exact, in_degree, mass)."""
    s, d = src.long(), dst.long()
    v = values.double()
    exact = torch.zeros(n, dtype=torch.float64,
                        device=values.device).index_add_(0, d, v[s])
    mass = torch.zeros(n, dtype=torch.float64,
                       device=values.device).index_add_(0, d, v.abs()[s])
    deg = torch.bincount(d, minlength=n).double()
    return exact, deg, mass, (deg + extra_terms) * F32_UNIT * mass


def offline_timeline(torch, device: str, n: int, epochs: int,
                     adds: int) -> dict:
    """``pagerank_timeline`` over every version of a preferential-attachment
    stream (``synthesize_stream``, seed 0), through the kernels, then WCC
    and the emerging vertices on its last snapshot. Launch counts are
    reset just before the timeline and read just after it."""
    import numpy as np

    from repro_torch.core.versioned import Version
    from repro_torch.device import to_host
    from repro_torch.graph import compute as gc
    from repro_torch.graph.dyngraph import synthesize_stream
    from repro_torch.kernels import ops

    t = time.perf_counter()
    g, _ = synthesize_stream(n, epochs, adds, seed=SEED, device=device)
    sync(torch, device)
    stream_s = time.perf_counter() - t
    versions = [Version(e, 0) for e in range(epochs)]
    full0, patched0 = g.view_full_builds, g.view_delta_patches
    ops.reset_launch_counts()
    t = time.perf_counter()
    with counting_pagerank() as runs:
        results = gc.pagerank_timeline(g, versions, incremental=True,
                                       tol=1e-6, max_iter=200)
    sync(torch, device)
    timeline_s = time.perf_counter() - t
    counts = ops.launch_counts()
    full = g.view_full_builds - full0
    patched = g.view_delta_patches - patched0
    iterations = [r.iterations for r in results]
    check(full + patched == epochs,
          f"timeline built {full} + {patched} views for {epochs} versions")
    check(runs.iterations == sum(iterations),
          f"{runs.iterations} PageRank iterations counted, "
          f"{sum(iterations)} reported")
    if device == "cuda":
        # one launch per iteration, one snapshot mask per view rebuilt
        # from the stamps (a delta-patched view needs none)
        check(counts["segment_sum"] == runs.iterations,
              f"timeline: segment_sum launched {counts['segment_sum']} "
              f"times in {runs.iterations} PageRank iterations")
        check(counts["liveness_mask"] == full >= 1,
              f"timeline: liveness_mask launched {counts['liveness_mask']} "
              f"times for {full} views rebuilt from the stamps")
    last = g.join_view(versions[-1])
    mask = g.snapshot_mask(versions[-1])
    check(mask.dtype == np.bool_ and mask.tobytes() == g.snapshot_mask(
        versions[-1], use_kernel=False).tobytes(),
        "last snapshot mask differs from its plain version")
    check(int(mask.sum()) == last.m, "last snapshot mask counts "
          f"{int(mask.sum())} live edges, the view {last.m}")
    plain = gc.incremental_pagerank(results[-2], None, last, tol=1e-6,
                                    max_iter=200, use_kernel=False)
    a, b = to_host(results[-1].ranks), to_host(plain.ranks)
    diff = float(np.abs(a - b).max())
    check(a.dtype == np.float32 and a.shape == (n,)
          and bool(np.isfinite(a).all()) and abs(float(a.sum()) - 1) < 1e-3,
          "timeline ranks are not a finite distribution")
    check(diff <= 1e-6, f"timeline last ranks: kernel vs plain {diff}")
    check(abs(results[-1].iterations - plain.iterations) <= 1,
          f"timeline last iterations {results[-1].iterations} vs plain "
          f"{plain.iterations}")
    t = time.perf_counter()
    labels = gc.wcc(last)
    src, dst = last.src.long(), last.dst.long()
    check(bool((labels[src] == labels[dst]).all()),
          "WCC: an edge joins two components")
    check(bool((labels <= torch.arange(n, device=labels.device)).all()),
          "WCC: a label above its vertex id")
    components = int(torch.unique(labels).numel())
    wcc_s = time.perf_counter() - t
    top = gc.emerging_vertices(g, versions[-3], versions[-1], top_k=10)
    growth = (to_host(last.in_degree)
              - to_host(g.join_view(versions[-3]).in_degree))
    check(growth[top[0]] == growth.max() and len(top) == 10,
          "emerging vertices: the first is not the largest growth")
    return {"graph": g, "versions": versions, "view": last,
            "stream_s": stream_s, "timeline_s": timeline_s,
            "iterations": iterations, "full_builds": full,
            "delta_patches": patched, "counts": counts,
            "pagerank_max_diff": diff, "components": components,
            "wcc_s": wcc_s, "emerging": top[:3].tolist(),
            "max_in_degree": int(last.in_degree.max())}


def check_partition_modes(torch, view, n_parts: int, hub_k: int) -> dict:
    """``partition_graph(view, n_parts, hub_k)`` and the three modes of
    ``distributed_join_group_by`` on random float32 values (Generator seed
    0): each within :func:`join_bound` of the float64 sum and of
    ``compute.join_group_by`` (the ``segment_sum`` kernel on a card). Two
    planted faults must exceed the bound: one partition's partials left
    out, and the mirror of the hub with the most out-edges zeroed."""
    from repro_torch.graph import compute as gc
    from repro_torch.graph import partition as gp

    device = view.src.device
    t = time.perf_counter()
    pg = gp.partition_graph(view, n_parts, hub_k=hub_k)
    sync(torch, device.type)
    build_s = time.perf_counter() - t
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    values = torch.rand(pg.n, generator=g, device=device)
    vn = view.n
    exact, deg, mass, bound = join_bound(torch, view.src, view.dst,
                                         values[:vn], vn, n_parts)
    kernel = gc.join_group_by(view, values[:vn])
    # the kernel's own sum: d terms, so d - 1 roundings at most
    both = bound + deg * F32_UNIT * mass
    out = {"n_parts": n_parts, "hub_k": hub_k, "m_pad": int(pg.src.shape[1]),
           "build_s": build_s, "comm_model": gp.comm_model(pg), "modes": {}}
    for mode in ("allgather", "scatter", "hub"):
        got = gp.distributed_join_group_by(pg, values, mode=mode)
        check(got.shape == (pg.n,) and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()),
              f"partition {mode}: shape {tuple(got.shape)}, {got.dtype}")
        err = (got[:vn].double() - exact).abs()
        vs_kernel = (got[:vn].double() - kernel.double()).abs()
        check(bool((err <= bound).all()),
              f"partition {mode}: max error {float(err.max())} over the "
              f"bound at vertex {int((err - bound).argmax())}")
        check(bool((vs_kernel <= both).all()),
              f"partition {mode}: differs from join_group_by by "
              f"{float(vs_kernel.max())}")
        check(bool((got[vn:] == 0).all()), f"partition {mode}: padding")
        ms = (cuda_ms(torch, lambda: gp.distributed_join_group_by(
            pg, values, mode=mode), reps=10) if device.type == "cuda"
            else None)
        out["modes"][mode] = {"max_abs_err": float(err.max()),
                              "vs_kernel": float(vs_kernel.max()),
                              "ms": ms}
    partials = gp.local_partials(pg, gp.mode_values(pg, values, "scatter"))
    drop = int(pg.mask.sum(1).argmax())
    kept = torch.cat([partials[:drop], partials[drop + 1:]]).sum(0)
    vals = gp.mode_values(pg, values, "hub")
    hub = int(pg.hubs[0])
    vals[:, hub] = 0
    zeroed = gp.local_partials(pg, vals).sum(0)
    out["planted"] = {}
    for name, bad in ((f"partition {drop} left out", kept),
                      (f"hub {hub} mirror zeroed", zeroed)):
        over = ((bad[:vn].double() - exact).abs() - bound).max()
        check(float(over) > 0, f"planted fault not caught: {name}")
        out["planted"][name] = float(over)
    return out


def check_models(torch, view, device: str,
                 pregel_stream=PREGEL_STREAM) -> dict:
    """The programming models on the protocol-dataflow runtime:
    ``run_edge_centric`` on ``view`` against ``compute.pagerank`` (40
    iterations, no dangling redistribution) within ``EDGE_CENTRIC_RTOL``
    of each rank; ``run_pregel`` with ``pagerank_program`` on a small
    stream (its per-edge Python loop bounds the size) within atol
    ``PREGEL_ATOL``, as the reference's test holds it, and within
    ``EDGE_CENTRIC_RTOL`` of each rank; ``run_mapreduce`` counting the
    destination ids of that stream's first ``MAPREDUCE_WORDS`` edge rows;
    a dataflow
    whose delivered events must respect its causal relation."""
    import numpy as np

    from repro_torch.core.protocol_dataflow import (Dataflow, Egress,
                                                    Ingress, Protocol,
                                                    Vertex)
    from repro_torch.core.versioned import Version
    from repro_torch.device import to_host
    from repro_torch.graph import compute as gc
    from repro_torch.graph.dyngraph import synthesize_stream
    from repro_torch.graph.models import (pagerank_program, run_edge_centric,
                                          run_mapreduce, run_pregel)

    out = {}
    t = time.perf_counter()
    ec = run_edge_centric(view, n_parts=4, iters=EDGE_CENTRIC_ITERS)
    out["edge_centric_s"] = time.perf_counter() - t
    pr = to_host(gc.pagerank(view, handle_dangling=False, tol=1e-12,
                             max_iter=EDGE_CENTRIC_ITERS).ranks)
    rel = float((np.abs(ec - pr) / np.abs(ec)).max())
    check(ec.shape == pr.shape and rel <= EDGE_CENTRIC_RTOL,
          f"edge-centric vs pagerank: max rel err {rel}")
    out["edge_centric_rel_err"] = rel

    g, _ = synthesize_stream(*pregel_stream, seed=SEED, device=device)
    small = g.join_view(Version(pregel_stream[1] - 1, 0))
    t = time.perf_counter()
    got = run_pregel(small, pagerank_program(n=small.n), n_parts=4,
                     init_value=1.0 / small.n, supersteps=200)
    out["pregel_s"] = time.perf_counter() - t
    want = to_host(gc.pagerank(small, tol=1e-12, max_iter=200,
                               handle_dangling=False).ranks)
    err = float(np.abs(got - want).max())
    rel = float((np.abs(got - want) / np.abs(got)).max())
    check(err <= PREGEL_ATOL and rel <= EDGE_CENTRIC_RTOL,
          f"pregel vs pagerank: max abs {err}, max rel {rel}")
    out.update(pregel_n=small.n, pregel_m=small.m, pregel_abs_err=err,
               pregel_rel_err=rel)

    # one event per word: the runtime's causal check is quadratic in them
    dst = to_host(small.dst)[:MAPREDUCE_WORDS]
    records = [" ".join(map(str, c)) for c in np.array_split(dst, 16)]
    counts = run_mapreduce(records,
                           map_fn=lambda line: [(int(w), 1)
                                                for w in line.split()],
                           reduce_fn=lambda k, vs: sum(vs))
    want = np.bincount(dst)
    check(counts == {int(v): int(want[v]) for v in np.flatnonzero(want)},
          "mapreduce word count differs from the destinations' counts")
    out["mapreduce_keys"] = len(counts)

    # ingress -> relay -> egress over three epochs: every ingress send
    # of an epoch happens before the relay's sends of that epoch
    def caused(e1, e2):
        p1, p2 = e1.payload, e2.payload
        if (e1.kind == e2.kind == "send" and p1["src"] == "ingress"
                and p2["src"] == "relay" and p1["epoch"] == p2["epoch"]):
            return True
        return None
    proto = Protocol("relay", happens_before=caused)
    df = Dataflow("causality")
    ingress = df.add(Ingress("ingress", proto))
    relay = df.add(Vertex("relay", proto,
                          lambda v, port, xs: [("out", sum(xs))]))
    egress = df.add(Egress("egress", proto, lambda x: None))
    ingress.connect("out", relay)
    relay.connect("out", egress)
    for epoch in range(3):
        ingress.push(range(4), epoch=epoch)
        df.run_until_quiescent()
    delivered = df.events.deliver()
    stamps = [e.stamp for e in delivered]
    check(len(delivered) == 15 and stamps == sorted(stamps)
          and df.events.check_causal_consistency(delivered)
          and not df.events.check_causal_consistency(delivered[::-1]),
          "dataflow event delivery broke its causal order")
    check(egress.received == [6, 6, 6], f"relay sums {egress.received}")
    out["dataflow_events"] = len(delivered)
    return out


def check_views_and_schema(torch, g, versions) -> dict:
    """``citation_schema``'s answers (the paper's Fig 2), and a
    lineage-tracked analytics view over the timeline (the rank growth
    between two snapshots) recovered after a simulated loss."""
    import numpy as np

    from repro_torch.core.views import View
    from repro_torch.device import to_host
    from repro_torch.graph import compute as gc
    from repro_torch.graph.schema import citation_schema

    reg = citation_schema()
    check(reg.fields_of("Author", 2) == {"name": "String",
                                         "contact": "String"}
          and reg.versions_of("Author") == [1, 2]
          and reg.link_allowed(("Author", 2), ("School", 1))
          and not reg.link_allowed(("Author", 1), ("School", 1))
          and reg.validate("Author", 2, {"name": "a", "contact": "b"})
          and not reg.validate("Author", 1, {"contact": "b"}),
          "citation_schema answers")
    builds = {"n": 0}

    def snapshot(v):
        def produce():
            builds["n"] += 1
            return g.join_view(v)
        return View.source(f"graph@{v.epoch}", produce, snapshot=v)

    def ranks(view):
        return to_host(gc.pagerank(view, tol=1e-6, max_iter=200).ranks)
    old = snapshot(versions[len(versions) // 2]).map("pagerank@mid", ranks)
    new = snapshot(versions[-1]).map("pagerank@last", ranks)
    table = View.join("rank growth top 10",
                      lambda a, b: np.argsort(a - b, kind="stable")[:10],
                      old, new)
    first = table.value()
    table.invalidate(recursive=True)
    again = table.recover()
    check(builds["n"] == 4 and again.tobytes() == first.tobytes()
          and table.spec.snapshot == versions[-1],
          "analytics view: lineage recovery differs")
    check(table.lineage() == [f"graph@{versions[len(versions) // 2].epoch}",
                              "pagerank@mid", f"graph@{versions[-1].epoch}",
                              "pagerank@last", "rank growth top 10"],
          f"analytics view lineage {table.lineage()}")
    return {"top_growth": first[:3].tolist()}


def check_segment_sum_power_law(torch, view) -> dict:
    """``segment_sum`` at the power-law snapshot's shape: the row of the
    checks line, held against the plain version within 2 d_max u / (1 -
    d_max u) of the largest sum (u = 2^-24: both are float32 sums of up
    to d_max positive terms, each within (d_max - 1) u of the exact sum,
    which is at most 1 / (1 - d_max u) times the float32 one), and every
    segment against the float64 sum within :func:`join_bound`."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    pr = torch.rand(view.n, generator=g, device="cuda")
    contrib = (pr / torch.clamp(view.out_degree, min=1.0))[view.src]
    d_max = int(view.in_degree.max())
    row = check_segment_sum(torch, "segment_sum", contrib[:, None]
                            .contiguous(), view.dst, view.n,
                            2 * d_max * F32_UNIT / (1 - d_max * F32_UNIT))
    got = ops.segment_sum(contrib[:, None].contiguous(), view.dst, view.n,
                          use_kernel=True)[:, 0]
    exact, _, _, bound = join_bound(torch, torch.arange(view.m,
                                                        device="cuda"),
                                    view.dst, contrib, view.n, 0)
    err = (got.double() - exact).abs()
    check(bool((err <= bound).all()),
          f"segment_sum power-law: max error {float(err.max())} vs float64")
    row.update(case="power-law", max_in_degree=d_max,
               max_err_vs_float64=float(err.max()))
    return row


# --------------------------------------------------------------- phase 7
def rpc_client(host, port, seed: int, n: int, count: int, out: list) -> None:
    """One client thread: ``count`` queries over the four kinds, one in
    four pinned to the version of this client's first answer; records
    (query, pin, response, round-trip seconds)."""
    import numpy as np

    from repro_torch.graph.query import (DegreeTopK, KHop, PageRankQuery,
                                         Reachability)
    from repro_torch.launch.rpc import GraphRPCClient

    rng = np.random.default_rng(seed)
    pin = None
    with GraphRPCClient(host, port, timeout_s=300.0) as cli:
        for i in range(count):
            kind = i % 4
            if kind == 0:
                q = KHop(source=int(rng.integers(n)), k=2)
            elif kind == 1:
                q = Reachability(src=int(rng.integers(n)),
                                 dst=int(rng.integers(n)), max_hops=6)
            elif kind == 2:
                q = DegreeTopK(k=8)
            else:
                q = PageRankQuery(top_k=8 if i % 8 == 3 else None)
            use_pin = pin if (i % 4 == 1 and pin is not None) else None
            t = time.perf_counter()
            r = cli.query(q, pin_version=use_pin)
            out.append((q, use_pin, r, time.perf_counter() - t))
            if r.ok and pin is None:
                pin = r.version


def serve_rpc(torch, device: str, n: int, epochs: int, adds: int,
              clients: int, per_client: int) -> dict:
    """``GraphRPCServer`` in front of a ``GraphQueryServer`` on a 4-shard
    store on ``device``, the churn stream (``delete_frac=0.2``, seed 0)
    ingested on a background thread while ``clients`` socket clients
    query it. Launch counts are reset just before and read just after.
    Every answer is then recomputed at the version it reports on the plain
    path: k-hop, reachability and top-k byte-equal; each PageRank run the
    server made through the kernels is run again from the same start on
    the plain route (within atol 1e-6), and the served ranks must be that
    run's, byte for byte."""
    import threading

    import numpy as np

    from repro_torch.device import to_host
    from repro_torch.graph.dyngraph import synthesize_churn_stream
    from repro_torch.graph.query import PageRankQuery, SnapshotQueryEngine
    from repro_torch.graph.sharded import ShardedDynamicGraph
    from repro_torch.kernels import ops
    from repro_torch.launch.rpc import GraphRPCServer
    from repro_torch.launch.serve_graph import GraphQueryServer

    batches = synthesize_churn_stream(n, epochs, adds, seed=SEED,
                                      delete_frac=0.2)
    e_max = sum(len(b.add_src) for b in batches) + 16
    sg = ShardedDynamicGraph(SHARDS, n, e_max, device=device)
    server = GraphQueryServer(sg, prewarm_pagerank=False, tol=1e-6,
                              max_iter=200)
    front = GraphRPCServer(server, port=0).start()
    answers: list = []
    ops.reset_launch_counts()
    t = time.perf_counter()
    try:
        with counting_pagerank(record=True) as runs:
            ingest = server.start_background_ingest(iter(batches))
            host, port = front.address
            threads = [threading.Thread(
                target=rpc_client, args=(host, port, SEED + c, n,
                                         per_client, answers))
                for c in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            ingest.join(timeout=600)
            sync(torch, device)
        check(not any(th.is_alive() for th in threads)
              and not ingest.is_alive(), "RPC clients or ingest hung")
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        stats = server.stats()
    finally:
        front.stop()
        sg.shutdown()
    check(len(answers) == clients * per_client,
          f"{len(answers)} answers for {clients * per_client} queries")
    check(sg.latest_sealed() == batches[-1].version,
          f"ingest stopped at {sg.latest_sealed()}")
    if device == "cuda":
        check(counts["liveness_mask"] > 0, "RPC: no liveness_mask launch")
        check(counts["segment_sum"] == runs.iterations > 0,
              f"RPC: segment_sum launched {counts['segment_sum']} times in "
              f"{runs.iterations} PageRank iterations")
    by_version: dict = {}
    diff = 0.0
    for view, kw, res in runs.runs:
        plain = runs.real(view, **{**kw, "use_kernel": False})
        a, b = to_host(res.ranks), to_host(plain.ranks)
        diff = max(diff, float(np.abs(a - b).max()))
        by_version.setdefault(view.version, []).append(a)
    check(diff <= 1e-6, f"RPC PageRank: kernel vs plain {diff}")
    plain_engine = SnapshotQueryEngine(result_cache=False, tol=1e-6,
                                       max_iter=200, use_kernel=False)
    views, pinned, kinds = {}, 0, {}
    for q, pin, r, _ in answers:
        check(r.ok, f"RPC {q}: {r.error}")
        check(pin is None or r.version == pin,
              f"RPC {q} pinned at {pin} answered at {r.version}")
        pinned += pin is not None
        kind = type(q).__name__
        kinds[kind] = kinds.get(kind, 0) + 1
        if r.version not in views:
            views[r.version] = sg.join_view(r.version)
        if isinstance(q, PageRankQuery):
            served = [full if q.top_k is None else
                      (np.argsort(-full, kind="stable")[:q.top_k],
                       full[np.argsort(-full, kind="stable")[:q.top_k]])
                      for full in by_version.get(r.version, [])]
            check(any(same_answer(np, r.value, s) for s in served),
                  f"RPC {q} at {r.version}: not the ranks of a kernel run")
        else:
            want = plain_engine.execute(views[r.version], [q])[0]
            check(same_answer(np, r.value, want),
                  f"RPC {q} at {r.version} differs from the plain answer")
    rtt = sorted(x for *_, x in answers)
    return {"graph": sg, "wall_s": wall, "served": stats.served,
            "counts": counts, "pagerank_runs": len(runs.runs),
            "pagerank_max_diff": diff, "pinned": pinned, "kinds": kinds,
            "versions": len(views),
            "rpc_p50_ms": rtt[len(rtt) // 2] * 1e3,
            "rpc_p99_ms": rtt[min(len(rtt) - 1,
                                  int(0.99 * len(rtt)))] * 1e3,
            "server_p50_ms": stats.query_p50_s * 1e3,
            "server_p99_ms": stats.query_p99_s * 1e3}


def check_sharded_partitions(torch, sg, hub_k: int) -> dict:
    """``partition_graph_sharded`` on the store's shard views at its last
    sealed version, both placements: ``allgather`` on ``dst_hash`` and
    ``scatter`` / ``hub`` on ``src`` against ``compute.join_group_by`` on
    the stitched view, within :func:`join_bound` plus the kernel's own
    rounding."""
    from repro_torch.graph import compute as gc
    from repro_torch.graph import partition as gp

    v = sg.latest_sealed()
    shard_views = sg.shard_views(v)
    view = sg.join_view(v)
    device = view.src.device
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 6)
    n_parts = len(shard_views)
    pgs = {p: gp.partition_graph_sharded(shard_views, hub_k=hub_k,
                                         placement=p)
           for p in ("dst_hash", "src")}
    values = torch.rand(pgs["src"].n, generator=g, device=device)
    vn = view.n
    _, deg, mass, bound = join_bound(torch, view.src, view.dst, values[:vn],
                                     vn, n_parts)
    kernel = gc.join_group_by(view, values[:vn]).double()
    both = bound + deg * F32_UNIT * mass
    out = {}
    for placement, mode in (("dst_hash", "allgather"), ("src", "scatter"),
                            ("src", "hub")):
        got = gp.distributed_join_group_by(pgs[placement], values, mode=mode)
        err = (got[:vn].double() - kernel).abs()
        check(bool((err <= both).all()),
              f"sharded {placement}/{mode}: differs from join_group_by by "
              f"{float(err.max())}")
        out[f"{placement}/{mode}"] = float(err.max())
    return out


# ------------------------------------------------------------------- main
# --------------------------------------------------------------- phase 8
# per route: the backward's source and its three kernels (one launch each)
FLASH_BWD_SOURCES = {
    "wgmma": ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              ("delta_sm90_kernel", "dkv_wgmma_kernel", "dq_wgmma_kernel")),
    "simt": ("src/repro_torch/csrc/flash_attention_bwd.cu",
             ("delta_kernel", "dkv_kernel", "dq_kernel"))}


def bwd_err(torch, got, want) -> float:
    """The largest max_rel_err over the gradients of one call."""
    return max(max_rel_err(torch, g, w) for g, w in zip(got, want,
                                                        strict=True)
               if w is not None)


def check_flash_attention_bwd(torch) -> tuple[dict, list[dict]]:
    """flash_attention_bwd against its plain version (the full S x S
    softmax gradient in float32), fed the same forward output and lse, at
    the training shape and at the forward's other shapes. Each case must
    launch the route that ``route(dtype, hd)`` names (bf16 at hd 64-256 the
    tensor-core kernels, ``wgmma``; the rest ``simt``); a ``wgmma`` case
    must give the same bits on a second call. Planted faults must exceed
    the limit: the lse one row off; with a window, the window one kv tile
    short; with a group of query heads, the last head of each group left
    out of the walk (its dO zeroed, which is what a dK/dV walk one head
    short and a dQ pass without that head give). Timed beside the plain
    version and SDPA's backward with the same boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = ((FLASH_TRAIN_SHAPE, bf16, FLASH_WINDOW, BWD_RTOL_BF16),
             ((1, 8, 2, 1024, 128), f32, None, BWD_RTOL_F32),
             ((2, 4, 2, 64, 16), bf16, None, BWD_RTOL_BF16),
             ((1, 8, 2, 1000, 128), bf16, 300, BWD_RTOL_BF16),
             ((2, 4, 4, 4097, 64), bf16, None, BWD_RTOL_BF16))
    rows = []
    for (B, Hq, Hkv, S, hd), dtype, window, tol in cases:
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(dtype) for shape in ((B, Hq, S, hd),
                                                (B, Hkv, S, hd),
                                                (B, Hkv, S, hd),
                                                (B, Hq, S, hd)))
        which = fa.route(dtype, hd)
        out, lse = fa.flash_attention(q, k, v, window=window,
                                      return_lse=True)
        ops.reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
        want = ref.flash_attention_bwd(q, k, v, out, do, window=window)
        torch.cuda.synchronize()
        check(ops.route_counts()["flash_attention_bwd"][which] == 1,
              f"flash_attention_bwd {tuple(q.shape)} {dtype}: did not "
              f"launch the {which} route ({ops.route_counts()})")
        check(all(x.dtype == dtype and x.shape == y.shape
                  for x, y in zip(got, (q, k, v), strict=True)),
              f"flash_attention_bwd {tuple(q.shape)}: dtypes or shapes")
        err = bwd_err(torch, got, want)
        check(err <= tol, f"flash_attention_bwd {tuple(q.shape)} {dtype} "
                          f"window={window}: {err} of the largest gradient "
                          f"over {tol}")
        bit_equal = None
        if which == "wgmma":
            again = fa.flash_attention_bwd(q, k, v, out, do, lse,
                                           window=window)
            bit_equal = all(torch.equal(x, y)
                            for x, y in zip(got, again, strict=True))
            check(bit_equal, f"flash_attention_bwd {tuple(q.shape)}: two "
                             "calls differ")
            del again
        faults = {"lse one row off": fa.flash_attention_bwd(
            q, k, v, out, do, lse.roll(1, -1), window=window)}
        if window is not None and window > 64:
            faults["window one kv tile short"] = fa.flash_attention_bwd(
                q, k, v, out, do, lse, window=window - 64)
        if Hq > Hkv:
            short = do.clone()
            short[:, Hq // Hkv - 1::Hq // Hkv] = 0
            faults["group walk one head short"] = fa.flash_attention_bwd(
                q, k, v, out, short, lse, window=window)
            del short
        planted_errs = {n: bwd_err(torch, f, want) for n, f in faults.items()}
        check(all(e > tol for e in planted_errs.values()),
              f"flash_attention_bwd planted faults not caught: "
              f"{planted_errs}")
        del got, faults

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, do, lse,
                                          window=window)
        source, names = FLASH_BWD_SOURCES[which]
        ms = cuda_ms(torch, kernel, reps=5)
        dev_split: dict = {}
        dev = device_ms(torch, kernel, names, reps=3, per_call=3,
                        split=dev_split)
        plain = cuda_ms(torch, lambda: ref.flash_attention_bwd(
            q, k, v, out, do, window=window), reps=3, warmup=1)
        del want
        # the library yardstick: SDPA's backward over kv heads expanded to
        # Hq, with the same boolean mask (timed only; the port never
        # calls it)
        qg = q.detach().requires_grad_()
        ke = k.repeat_interleave(Hq // Hkv, dim=1).requires_grad_()
        ve = v.repeat_interleave(Hq // Hkv, dim=1).requires_grad_()
        if window is None:
            o = F.scaled_dot_product_attention(qg, ke, ve, is_causal=True)
        else:
            pos = torch.arange(S, device="cuda")
            d = pos[:, None] - pos[None, :]
            o = F.scaled_dot_product_attention(
                qg, ke, ve, attn_mask=(d >= 0) & (d < window))
        library = cuda_ms(torch, lambda: torch.autograd.grad(
            o, (qg, ke, ve), do, retain_graph=True), reps=5)
        del o, qg, ke, ve
        pairs = B * Hq * causal_pairs(S, window)
        esize = q.element_size()
        nbytes = esize * (4 * B * Hq * S * hd + 4 * B * Hkv * S * hd) \
            + 4 * B * Hq * S
        row = kernel_row(
            "flash_attention_bwd", source,
            "src/repro/kernels/flash_attention.py:78", max_abs_err=err,
            ms=ms, plain_ms=plain, nbytes=nbytes, ops=10 * hd * pairs,
            library_ms=library,
            shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},hd={hd},"
                  f"{str(dtype).split('.')[-1]},window={window}",
            ops_per_s=BF16_TC_OPS_PER_S if dtype == bf16 else FP32_OPS_PER_S,
            kernel_route=which, dev_ms=dev)
        row["device_ms_split"] = dev_split
        row["planted"] = planted_errs
        row["limit"] = tol
        row["bit_equal"] = bit_equal
        rows.append(row)
        del q, k, v, do, out, lse
    return rows[0], rows[1:]


LRU_BWD_KERNELS = ("lru_scan_bwd_carry_kernel", "lru_scan_bwd_kernel")


def lru_scan_bwd_carry_dropped(torch, a, h, dh, h0, chunk: int):
    """The backward's two launches as ``kernels.lru_scan.lru_scan_bwd``
    makes them, with one chunk's carry (chunk 1, or 0 when there is one)
    zeroed between them: a planted fault of the chunked design, which
    loses that chunk's part of every carry to its left."""
    from repro_torch.kernels import _lib

    B, S, C = a.shape
    n = -(-S // chunk)
    carry = torch.empty((2, B, n, C), dtype=torch.float32, device=a.device)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    lib, stream = _lib.load(), _lib.stream_of(a)
    _lib.check(lib.rt_lru_scan_bwd_carry(a.data_ptr(), dh.data_ptr(),
                                         carry.data_ptr(), B, S, C, chunk,
                                         stream), "carry pass")
    carry[:, :, min(1, n - 1)] = 0
    _lib.check(lib.rt_lru_scan_bwd(
        a.data_ptr(), h.data_ptr(), None if h0 is None else h0.data_ptr(),
        dh.data_ptr(), carry.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), B, S, C, chunk, stream),
        "apply pass")
    return da, db, dh0


def check_lru_scan_bwd(torch) -> tuple[dict, dict]:
    """lru_scan_bwd (the chunked scan over time) against its plain version
    (the sequential walk) at the training shape and at S = 1, L - 1, L,
    L + 1 and 4096 + 3 for the chunk length L, each with and without h0:
    da, db and dh0 within LRU_BWD_RTOL of their largest magnitudes, and the
    same bits on a second call. Planted faults must exceed the limit: dh
    one step late (at the training shape), and one chunk's carry dropped
    (wherever there are two chunks). Also times the forward lru_scan at
    the training shape (its row in the checks line)."""
    from repro_torch.kernels import lru_scan as lru
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 6)
    B, S_train, C = LRU_TRAIN_SHAPE
    L = lru.BWD_CHUNK
    errs, planted_errs = {}, {}
    for S in (S_train, 1, L - 1, L, L + 1, 4096 + 3):
        for with_h0 in (False, True):
            shape = (B, S, C)
            a = 0.5 + 0.499 * torch.rand(shape, generator=g, device="cuda")
            b = torch.randn(shape, generator=g, device="cuda")
            h0 = (torch.randn((B, C), generator=g, device="cuda")
                  if with_h0 else None)
            h = lru.lru_scan(a, b, h0)
            dh = torch.randn(shape, generator=g, device="cuda")
            got = lru.lru_scan_bwd(a, h, dh, h0, want_dh0=True)
            want = ref.lru_scan_bwd(a, h, dh, h0)
            again = lru.lru_scan_bwd(a, h, dh, h0, want_dh0=True)
            torch.cuda.synchronize()
            key = f"S={S},h0={with_h0}"
            errs[key] = bwd_err(torch, got, want)
            check(errs[key] <= LRU_BWD_RTOL,
                  f"lru_scan_bwd {key}: {errs[key]} of the largest "
                  f"gradient over {LRU_BWD_RTOL}")
            check(all(x is None or torch.equal(x, y)
                      for x, y in zip(got, again, strict=True)),
                  f"lru_scan_bwd {key}: two calls differ")
            faults = {}
            if S == S_train:
                faults["dh one step late"] = lru.lru_scan_bwd(
                    a, h, dh.roll(1, 1), h0, want_dh0=True)
            if S > L:
                faults["one chunk's carry dropped"] = \
                    lru_scan_bwd_carry_dropped(torch, a, h, dh, h0, L)
            for name, bad in faults.items():
                planted_errs[f"{key} {name}"] = bwd_err(torch, bad, want)
            if S == S_train and not with_h0:
                ms = cuda_ms(torch, lambda: lru.lru_scan_bwd(a, h, dh))
                dev_split: dict = {}
                dev = device_ms(torch, lambda: lru.lru_scan_bwd(a, h, dh),
                                LRU_BWD_KERNELS, per_call=2, split=dev_split)
                plain = cuda_ms(torch, lambda: ref.lru_scan_bwd(a, h, dh),
                                reps=3, warmup=1)
                fwd = {"ms": cuda_ms(torch, lambda: lru.lru_scan(a, b)),
                       "dev": device_ms(torch, lambda: lru.lru_scan(a, b),
                                        "lru_scan_kernel"),
                       "plain": cuda_ms(torch, lambda: ref.lru_scan(a, b),
                                        reps=3, warmup=1),
                       "err": float((lru.lru_scan(a, b)
                                     - ref.lru_scan(a, b)).abs().max())}
            del a, b, h0, h, dh, got, want, again, faults
    missed = {k: e for k, e in planted_errs.items() if e <= LRU_BWD_RTOL}
    check(not missed, f"lru_scan_bwd planted faults not caught: {missed}")
    log(f"phase 8a lru_scan_bwd (chunk {L}) max rel err {errs} (limit "
        f"{LRU_BWD_RTOL}), bit-equal on a second call; planted "
        f"{planted_errs}")
    n = B * S_train * C
    shape = f"B={B},S={S_train},C={C},float32"
    row = kernel_row(
        "lru_scan_bwd", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52",
        max_abs_err=errs[f"S={S_train},h0=False"], ms=ms, plain_ms=plain,
        nbytes=20 * n, ops=3 * n, library_ms=None, shape=shape, dev_ms=dev)
    row["device_ms_split"] = dev_split
    row["planted"] = {k: e for k, e in planted_errs.items()
                      if k.startswith(f"S={S_train},")}
    row["limit"] = LRU_BWD_RTOL
    row["bit_equal"] = True
    fwd_row = kernel_row(
        "lru_scan", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52", max_abs_err=fwd["err"],
        ms=fwd["ms"], plain_ms=fwd["plain"], nbytes=12 * n, ops=2 * n,
        library_ms=None, shape=shape + " (training)", dev_ms=fwd["dev"])
    return row, fwd_row


def training_batch(cfg, index: int, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ) -> dict:
    """Batch ``index`` of the training pipeline (Markov data, seed 0)."""
    from repro_torch.train.data import TokenPipeline

    return TokenPipeline(cfg.vocab_size, batch, seq,
                         seed=SEED).batch_view(index).value()


def check_training_gradients(torch, cfg, device: str = "cuda",
                             batch: int = TRAIN_BATCH,
                             seq: int = TRAIN_SEQ) -> dict:
    """One unit (3 layers) of ``cfg`` at full width: the loss and every
    parameter's gradient through the kernel route (forward and backward
    kernels) against the plain route (autograd of the plain versions), both
    on the card from the same float32 master weights (seed 0) and batch.
    Each gradient within GRAD_RTOL of its largest magnitude (bf16 compute on
    both routes, rounded at other places); faults planted in the backward
    kernels must exceed it."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as lru
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    model = tf.init_params(cfg, g, device, trainable=True)
    data = training_batch(cfg, 0, batch, seq)

    def grads(use_kernel):
        model.zero_grad(set_to_none=True)
        loss, _ = steps.loss_fn(model, cfg, data, use_kernel)
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    t = time.perf_counter()
    plain_loss, plain = grads(False)
    sync(torch, device)
    plain_s = time.perf_counter() - t
    t = time.perf_counter()
    kernel_loss, kernel = grads(None)
    sync(torch, device)
    kernel_s = time.perf_counter() - t
    errs = {n: max_rel_err(torch, kernel[n], plain[n]) for n in plain}
    del kernel
    loss_err = abs(kernel_loss - plain_loss) / abs(plain_loss)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= GRAD_RTOL and loss_err <= GRAD_RTOL,
          f"kernel vs plain gradients: {worst} off by {errs[worst]}, loss "
          f"by {loss_err} (limit {GRAD_RTOL})")
    faults = {"attention backward without its window": planted(
                  "flash_attention_bwd", window_to(None), fa),
              "scan backward with dh one step late": planted(
                  "lru_scan_bwd", lambda args, kw: (
                      args[:2] + (args[2].roll(1, 1),) + args[3:], kw),
                  lru)}
    planted_errs = {}
    for name, fault in faults.items():
        with fault:
            _, bad = grads(None)
        planted_errs[name] = max(max_rel_err(torch, bad[n], plain[n])
                                 for n in plain)
        del bad
    missed = [n for n, e in planted_errs.items() if e <= GRAD_RTOL]
    check(not missed, f"planted faults not caught: {planted_errs}")
    del model, plain
    return {"layers": cfg.num_layers, "loss_kernel": kernel_loss,
            "loss_plain": plain_loss, "loss_rel_err": loss_err,
            "worst": worst, "worst_rel_err": errs[worst],
            "per_param": errs, "planted": planted_errs,
            "kernel_s": kernel_s, "plain_s": plain_s}


def launches_per_step(cfg) -> dict:
    """Kernel launches of one train step with cfg.remat "full": the units'
    forward kernels run twice (the forward and the recompute in the
    backward), the tail's once; each layer's backward kernel once."""
    unit = list(cfg.pattern) * cfg.num_units
    tail = list(cfg.tail_pattern)
    rg_u, rg_t = unit.count("rglru"), tail.count("rglru")
    at_u, at_t = len(unit) - rg_u, len(tail) - rg_t
    return {"lru_scan": 2 * rg_u + rg_t, "lru_scan_bwd": rg_u + rg_t,
            "flash_attention": 2 * at_u + at_t,
            "flash_attention_bwd": at_u + at_t}


def train_model(torch, cfg, device: str = "cuda", batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> dict:
    """The main path of phase 8: ``launch.train.run`` on ``cfg`` at full
    width and depth, TRAIN_WARMUP + TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ Markov tokens (seed 0), with the launch counts reset just
    before and read just after."""
    import math

    from repro_torch.kernels import ops
    from repro_torch.launch import train as ptrain

    steps_n = TRAIN_WARMUP + TRAIN_STEPS
    times: list[float] = []
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    losses, state = ptrain.run(cfg, steps=steps_n, batch=batch, seq=seq,
                               ckpt_dir=None, log_every=1, seed=SEED,
                               device=device, timings=times)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    routes = ops.route_counts()["flash_attention"]
    want = {k: v * steps_n if on_card else 0
            for k, v in launches_per_step(cfg).items()}
    for name, n in want.items():
        check(counts[name] == n,
              f"training launched {name} {counts[name]} times, expected {n} "
              f"({steps_n} steps)")
    bwd_routes = ops.route_counts()["flash_attention_bwd"]
    check(routes["wgmma"] == want["flash_attention"],
          f"training flash_attention routes {routes}")
    check(bwd_routes["wgmma"] == want["flash_attention_bwd"],
          f"training flash_attention_bwd routes {bwd_routes}")
    vals = [losses[i] for i in range(steps_n)]
    check(all(math.isfinite(x) for x in vals), f"losses {vals}")
    check(abs(vals[0] - math.log(cfg.vocab_size)) < FIRST_LOSS_TOL,
          f"first loss {vals[0]}, ln(vocab) {math.log(cfg.vocab_size)}")
    step_s = statistics.median(times[TRAIN_WARMUP:])
    return {"cfg": cfg, "state": state, "losses": vals, "times": times,
            "step_s": step_s, "tokens_per_s": batch * seq / step_s,
            "wall_s": wall, "counts": counts, "routes": routes,
            "bwd_routes": bwd_routes,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else None),
            "params": sum(p.numel() for p in state["params"].parameters())}


def train_time_split(torch, run: dict) -> dict:
    """One more step of the trained state, taken apart with a synchronise
    between the parts: forward (embedding, units, tail, final norm), loss
    chunks, backward (with the units' and the chunks' recompute),
    optimizer; then the units' forward alone without grad, the size of the
    backward's recompute. The device busy share and the kernels that take
    the most device time come from ``torch.profiler`` (device activity
    only) over the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.train.loss import chunked_cross_entropy
    from repro_torch.train.optimizer import OptConfig, adamw_update

    cfg, state = run["cfg"], run["state"]
    model = state["params"]
    batch = training_batch(cfg, TRAIN_WARMUP + TRAIN_STEPS)
    inputs = torch.from_numpy(batch["inputs"]).cuda()
    labels = torch.from_numpy(batch["labels"]).cuda()
    pos = steps.make_positions(TRAIN_BATCH, TRAIN_SEQ, "cuda")
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark()
        hidden, _ = tf.forward(model, cfg, inputs, pos)
        mark()
        loss_sum, cnt = chunked_cross_entropy(model.lm_head, hidden, labels,
                                              chunk=cfg.loss_chunk)
        loss = loss_sum / cnt
        mark()
        loss.backward()
        mark()
        adamw_update(OptConfig(), model, state["opt"])
        model.zero_grad(set_to_none=True)
        mark()
    del hidden, loss_sum, loss
    with torch.no_grad():
        mark()
        x = tf.embed_inputs(model, cfg, inputs, pos)
        for unit in model.units:
            for i, kind in enumerate(cfg.pattern):
                x, _ = tf.apply_block(unit[f"b{i}"], x, cfg, kind, pos)
        mark()
        del x
    fwd, loss_s, bwd, opt = (b - a for a, b in zip(marks[:4], marks[1:5],
                                                   strict=True))
    units = marks[6] - marks[5]
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"forward_s": fwd, "loss_chunks_s": loss_s, "backward_s": bwd,
            "optimizer_s": opt, "units_forward_no_grad_s": units,
            "step_s": marks[4] - marks[0],
            "busy_share": busy_us / ((marks[4] - marks[0]) * 1e6),
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in top}}


def train_fault_path(torch, cfg, device: str = "cuda") -> dict:
    """The driver's fault path on the card, on the reduced config: a run
    that fails at step 8 and restores snapshot(latest) (checkpoints every 5
    steps) against an uninterrupted run (losses equal within 1e-6: the
    kernels are deterministic and the restore copies float32 exactly); the
    same with --compress (within 1e-3: as in the reference, the
    error-feedback state is not rolled back with the checkpoint, so the
    replayed steps see another residual); then the port's checkpoint is
    restored by ``launch.serve.Server.from_checkpoint``, which generates."""
    import tempfile

    import numpy as np

    from repro_torch.launch import train as ptrain
    from repro_torch.launch.serve import Server

    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    kw = {"steps": 12, "batch": 4, "seq": 64, "ckpt_every": 5,
          "log_every": 100, "seed": SEED, "device": device}
    out = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        clean, _ = ptrain.run(cfg, ckpt_dir=f"{tmp}/clean", **kw)
        fault, state = ptrain.run(cfg, ckpt_dir=f"{tmp}/fault", fail_at=8,
                                  **kw)
        c_clean, _ = ptrain.run(cfg, ckpt_dir=f"{tmp}/cclean", compress=True,
                                **kw)
        c_fault, _ = ptrain.run(cfg, ckpt_dir=f"{tmp}/cfault", compress=True,
                                fail_at=8, **kw)
        check(int(state["step"]) == kw["steps"], f"step {state['step']}")
        for name, got, want, tol in (("fail_at", fault, clean, 1e-6),
                                     ("compress", c_fault, c_clean, 1e-3)):
            diff = max(abs(got[i] - want[i]) / abs(want[i])
                       for i in range(kw["steps"]))
            check(len(got) == kw["steps"] and diff <= tol,
                  f"{name}: losses after recovery off by {diff} (limit {tol})")
            out[f"{name}_rel_diff"] = diff
        server = Server.from_checkpoint(cfg, f"{tmp}/fault", device=device)
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)
        tokens = server.generate(prompts, 4)
        check(tokens.shape == (2, 4) and bool(((tokens >= 0)
                                               & (tokens < cfg.vocab_size))
                                              .all()),
              f"served tokens {tokens}")
        out.update({"losses": [clean[i] for i in range(kw["steps"])],
                    "compress_losses": [c_clean[i]
                                        for i in range(kw["steps"])],
                    "served": tokens.tolist()})
    return out


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
    log(f"phase 1 ptxas (no spills) and SASS (HGMMA): "
        f"{json.dumps(check_kernel_build())}")

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

    from repro_torch.configs import get_config, reduced

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

    t = time.perf_counter()
    tl = offline_timeline(torch, "cuda", OFFLINE_N, OFFLINE_EPOCHS,
                          OFFLINE_ADDS)
    view = tl["view"]
    log(f"phase 6 timeline: stream of {OFFLINE_EPOCHS} x {OFFLINE_ADDS} "
        f"adds on {OFFLINE_N} vertices {tl['stream_s']:.3f} s; "
        f"pagerank_timeline over {OFFLINE_EPOCHS} versions "
        f"{tl['timeline_s']:.3f} s ({tl['timeline_s'] / OFFLINE_EPOCHS:.3f}"
        f" s per version), PageRank iterations per version "
        f"{tl['iterations']}; views rebuilt from the stamps "
        f"{tl['full_builds']}, delta-patched {tl['delta_patches']}; "
        f"launches {tl['counts']}; last snapshot m={view.m}, max in-degree "
        f"{tl['max_in_degree']}; last ranks kernel vs plain "
        f"{tl['pagerank_max_diff']:.3e}; WCC {tl['components']} components "
        f"in {tl['wcc_s']:.3f} s; emerging vertices {tl['emerging']}")
    parts = check_partition_modes(torch, view, PARTS, HUB_K)
    log(f"phase 6 partitioned join-group-by (one card emulating {PARTS} "
        f"partitions; ms per call, comm_model bytes per superstep): "
        f"{json.dumps(parts)}")
    models = check_models(torch, view, "cuda")
    log(f"phase 6 programming models: {json.dumps(models)}")
    views = check_views_and_schema(torch, tl["graph"], tl["versions"])
    extra.append(check_segment_sum_power_law(torch, view))
    log(f"phase 6 views and schema: {json.dumps(views)}; power-law "
        f"segment_sum {json.dumps(extra[-1])}")
    log(f"phase 6 offline plane: {time.perf_counter() - t:.3f} s")
    del tl, view

    t = time.perf_counter()
    rpc = serve_rpc(torch, "cuda", RPC_N, RPC_EPOCHS, RPC_ADDS, RPC_CLIENTS,
                    RPC_QUERIES)
    sharded = check_sharded_partitions(torch, rpc["graph"], HUB_K)
    rpc["graph"].shutdown()
    log(f"phase 7 RPC tier: {RPC_CLIENTS} clients x {RPC_QUERIES} queries "
        f"while {RPC_EPOCHS} epochs of {RPC_ADDS} adds on {RPC_N} vertices "
        f"ingest, {rpc['wall_s']:.3f} s; served {rpc['served']} "
        f"({rpc['kinds']}, {rpc['pinned']} pinned, at {rpc['versions']} "
        f"versions); RPC round trip p50 {rpc['rpc_p50_ms']:.3f} ms, p99 "
        f"{rpc['rpc_p99_ms']:.3f} ms (server p50 "
        f"{rpc['server_p50_ms']:.3f} ms, p99 {rpc['server_p99_ms']:.3f} "
        f"ms); launches {rpc['counts']}; {rpc['pagerank_runs']} PageRank "
        f"runs, kernel vs plain {rpc['pagerank_max_diff']:.3e}; sharded "
        f"partitions vs join_group_by {json.dumps(sharded)}; phase "
        f"{time.perf_counter() - t:.3f} s")
    del rpc
    torch.cuda.empty_cache()

    t = time.perf_counter()
    fa_bwd_row, fa_bwd_extra = check_flash_attention_bwd(torch)
    lru_bwd_row, lru_train_row = check_lru_scan_bwd(torch)
    extra.extend(fa_bwd_extra)
    extra.append(lru_train_row)
    log("phase 8a flash_attention_bwd vs plain (route, max rel err, limit, "
        "bit-equal, planted): " + "; ".join(
            f"{r['shape']} {r['kernel_route']} {r['max_abs_err']:.3e} "
            f"{r['limit']} {r['bit_equal']} {json.dumps(r['planted'])}"
            for r in [fa_bwd_row] + fa_bwd_extra))
    log(f"phase 8a backward kernels vs plain: {time.perf_counter() - t:.3f}"
        " s")
    t = time.perf_counter()
    train_cfg = get_config(MODEL_ARCH)
    grads = check_training_gradients(torch, train_cfg)
    torch.cuda.empty_cache()
    log(f"phase 8b one unit ({grads['layers']} layers) at full width, "
        f"kernel vs plain route on the card: loss {grads['loss_kernel']:.6f}"
        f" vs {grads['loss_plain']:.6f}; worst gradient {grads['worst']} "
        f"{grads['worst_rel_err']:.3e} (limit {GRAD_RTOL}); planted "
        f"{json.dumps(grads['planted'])}; kernel route "
        f"{grads['kernel_s']:.3f} s, plain {grads['plain_s']:.3f} s; phase "
        f"{time.perf_counter() - t:.3f} s")
    log("phase 8b per-parameter gradient max rel err: " + json.dumps(
        {k: float(f"{v:.3e}") for k, v in grads["per_param"].items()}))
    t = time.perf_counter()
    train_run = train_model(torch, train_cfg)
    train_counts = train_run["counts"]
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 8c train {MODEL_ARCH}: {train_run['params']} parameters, "
        f"{TRAIN_WARMUP} + {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: losses "
        + " ".join(f"{x:.4f}" for x in train_run["losses"])
        + "; step s " + " ".join(f"{x:.3f}" for x in train_run["times"])
        + f"; median timed step {train_run['step_s']:.3f} s, "
        f"{train_run['tokens_per_s']:.1f} tokens/s ({tokens_step} per step);"
        f" peak device memory {train_run['peak_gib']:.3f} GiB; launches "
        f"{train_counts} (per step {launches_per_step(train_cfg)}), "
        f"flash_attention routes {train_run['routes']}, "
        f"flash_attention_bwd routes {train_run['bwd_routes']}; run "
        f"{train_run['wall_s']:.3f} s")
    split = train_time_split(torch, train_run)
    log(f"phase 8c time split of one more step: {json.dumps(split)}")
    del train_run
    torch.cuda.empty_cache()
    fault = train_fault_path(torch, reduced(train_cfg))
    log(f"phase 8d fault path on reduced {MODEL_ARCH}: {json.dumps(fault)}; "
        f"phase 8 {time.perf_counter() - t:.3f} s")
    rows.extend([lru_bwd_row, fa_bwd_row])
    lru_train_row["launches_training"] = train_counts["lru_scan"]

    for row in rows:
        name = row["name"]
        if name in ("lru_scan_bwd", "flash_attention_bwd"):
            row["launches"] = train_counts[name]
            continue
        row["launches"] = (model_counts if name in ("lru_scan",
                                                    "flash_attention")
                           else counts)[name]
        if name in ("lru_scan", "flash_attention"):
            # the training path's launches of the same kernel (phase 8c)
            row["launches_training"] = train_counts[name]
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
