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
   drives it: 1,048,576 vertices in 4 shards on the card, an 8-epoch churn
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
   vertices, 4 epochs of 1,000,000 adds, seed 0), whose in-degrees follow
   a power law. Launch counts are reset just before ``pagerank_timeline``
   runs over all 4 versions (incremental, tol 1e-6, max_iter 200) and read
   just after: ``segment_sum`` once per PageRank iteration,
   ``liveness_mask`` once per view rebuilt from the stamps. The last
   ranks against the plain route within atol 1e-6; WCC and the emerging
   vertices. WCC's kernel route (``wcc_round``, one launch a round)
   against its plain route, bit-equal labels at caps 1, 2, 3 and the
   default, on the last view, a 100,000-vertex path whose ids fall along
   it (also at caps 50 and to the end), a star of 2^20 in-edges, self-loops
   and duplicate edges, and no edges; launches equal the plain rounds; two
   planted faults (in place, half the edges) must be caught. Then
   ``partition_graph(view, 16, hub_k=64)`` and the three
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

9. The dense-attention and frames families at full width, each built on
   the card from ``torch.Generator`` seed 0 in bf16 and freed before the
   next: ``starcoder2-7b`` (32 layers), ``gemma3-27b`` (62: 52 local with
   window 1024, 10 global) and ``qwen1.5-110b`` (20 of its 80 layers) through
   ``Server.generate`` (8, 2 and 2 requests of 4096 prompt tokens + 32
   greedy); ``musicgen-medium`` (48 layers) and ``internvl2-76b`` (32 of
   80) on frames (NumPy seed 0) through ``tf.prefill`` and 32
   ``steps.make_decode_step`` calls (8 and 2 requests of 4096 frames).
   Per model: ``flash_attention`` launched once per attention layer, all
   on ``wgmma``, none of ``lru_scan``; each layer's mixer kernel vs plain
   within ``MIXER_RTOL`` with planted faults (the causal mask off, the kv
   heads rolled by one, and for gemma3's local layers the window dropped
   and one kv tile short); the whole prefill kernel vs plain within the
   model's ``FAMILY_PREFILL_RTOL``, as a second sound route (P rounded
   once to bf16) must be too, the causal mask off and the kv heads rolled
   planted in every layer and a control route that keeps P to 4
   significant bits exceeding it; prefill s,
   decode ms per step beside the bytes a step must read over 3.35 TB/s,
   peak memory, and one prefill and 4 decode steps under torch.profiler.
   Then ``musicgen-medium`` trains: one layer's gradients kernel vs plain
   route on a frames batch (``GRAD_RTOL``), and ``launch.train.run`` on
   the full model, 1 + 2 steps of 2 x 4096 frames (96 ``flash_attention``
   and 48 ``flash_attention_bwd`` launches a step, all on ``wgmma``; the
   first loss within 1 of ln(2048)). The kernels line gains one
   ``flash_attention`` row per attention shape phase 9 launched and a
   ``flash_attention_bwd`` row at musicgen's training shape.
10. The MoE family at full width, built as phase 9's models are:
   ``mixtral-8x22b`` (10 of its 56 layers, every one sliding-window
   attention with the window of 4096 applied) through ``Server.generate``
   on 1 x 8192 prompt tokens + 32 greedy, and ``phi3.5-moe-42b-a6.6b``
   (20 of 32) on 2 x 4096 + 32, both on the dense dispatch. Per model:
   ``flash_attention`` once per layer on ``wgmma``; each layer's mixer
   kernel vs plain as in phase 9 (mixtral's with the window faults); one
   MoE layer: routers float32 beside bf16 experts, dropping at capacity
   8 against dense and 4 groups against one (``MIXER_RTOL``), two
   dropping calls bit-equal, timed beside its FLOP bound; the routing
   layer by layer on the plain route's hidden state, where the router in
   bf16 must flip ``BF16_ROUTER_FLIPS`` times the tokens that the kernel's
   or a sound route's bf16 step does; the whole prefill kernel vs plain
   within ``MOE_PREFILL_RTOL`` with the plain route's routing replayed
   (its expert sets and, dropping, its slots, weighted by the kernel
   route's own probabilities), the routing flip share (the (token, layer)
   pairs whose top-k expert sets differ between the routes) and the
   prefill as it runs reported; a sound route (P rounded once to bf16)
   within the limit, the control (P kept to 4 bits), attention faults
   (the causal mask off, the kv heads rolled) and routing faults (top_w
   not renormalised, the (k+1)-th expert chosen) over it, the router in
   bf16 reported. Mixtral's prefill again on the dropping dispatch
   (capacity 1.25; the sound route, the control and ``sel_w`` left out)
   and a 2048-token dropping prefill on 4 groups. Then
   phi3.5-moe trains at full width cut to 2 layers, 1 + 2 steps of 2 x
   2048 Markov tokens, and the next batch's loss must hold a nonzero aux
   whose gradient reaches every router. The kernels line gains a
   ``flash_attention`` row per new shape (serving and training) and a
   ``flash_attention_bwd`` row at phi3.5-moe's training shape.
11. The xLSTM family, which holds no kernel (the reference computes it
   with ``lax.scan`` and einsums; the port with tensor code and a loop
   over time): ``xlstm-1.3b`` at full width and depth (48 layers, 2.02 B
   parameters, random from seed 0, bf16 where only ``dense`` reads a
   weight) through ``Server.generate`` on its own route (the mLSTM scan),
   2 x 1024 prompt tokens + 32 greedy; no kernel launched; prefill s,
   decode ms beside the bytes a step must move (weights, and the states
   read and written), the launches, host ms and device ms of one mLSTM
   scan step and one sLSTM step. The chunkwise route (chunk 64) on the
   same prompts against the scan route: layer by layer, each mixer fed
   the scan route's input (output within ``MIXER_RTOL``, states within
   ``XLSTM_STATE_RTOL``, the carry without decay_in planted over them),
   and the whole prefill within ``XLSTM_ROUTE_RTOL``; then the decode
   steps and one layer of each kind's prefill profiled (busy share).
   Continuity on palindromic convolution kernels (the reference's decode
   reverses the kernel): prefill 256 and decode 32 of the prompt's next
   tokens against a prefill of 288, layer by layer
   (``XLSTM_CONT_OUT_RTOL``, states ``XLSTM_CONT_RTOL``; the decode's
   outputs kept to 4 bits in each layer and its conv state left
   unshifted over them; the random kernels' gap and the gap without the
   prefill's conv rounding reported) and whole
   (``XLSTM_CONT_WHOLE_RTOL``). A
   chunkwise prefill of 4 x 4096 through 4 layers, timed. One full-width
   layer of each mixer (1 x 256) against the same function with its
   float32 arithmetic in float64: the output within ``MIXER_RTOL``, the
   states within ``XLSTM_STATE_RTOL``, the sLSTM's gelu within
   ``XLSTM_GELU_RTOL``, with planted faults (the stabiliser m held at 0,
   the prefill's conv output unrounded, the chunkwise carry without
   decay_in, the i and f gates swapped, the exact ``F.gelu``) each over
   a limit. Then training: ``check_fits`` passes the full model (32.3 GB
   of float32 state), and ``launch.train.run`` trains it cut to 2 layers
   on the chunkwise route, 1 + 2 steps of 2 x 2048 tokens, the first loss
   within 1 of ln(50304). Every line carries the card's name and power
   limit; the kernels line is unchanged.
12. The dry-run, sharding rules and elastic restart on the card. (a)
   ``recurrentgemma-2b`` at full width cut to one unit (3 layers; 26
   layers' float32 params, m and v are a checkpoint of about 40 GB, one
   unit's 18.5 GB) trains through ``launch.train.run`` 2 steps of 2 x
   4096 with a checkpoint at step 2 (its bytes and save seconds
   printed), and 2 more steps: the uninterrupted run.
   ``train.elastic.elastic_restart`` restores snapshot(2) onto the CPU,
   bit-equal to the card's state at step 2, and onto the card, where 2
   steps must give the uninterrupted losses exactly at batch indices 2
   and 3, with ``launches_per_step``'s kernel launches each step, every
   attention launch forward and backward on ``wgmma``. (b) The dry-run's
   count (``launch.dryrun.count_step``, meta tensors standing for the
   card) of phase 5's prefill and phase 8c's step: the predicted peak
   within ``PEAK_RTOL`` of the measured one (less what earlier phases left
   allocated), the predicted flops and bytes and the roofline row beside
   the measured time. Nothing of phases 5 and 8c is run again.
13. The elastic and durable graph plane (``elastic_plane``). (a) A
   ``GraphQueryServer`` (auto-reshard, mirrors of the 64 hottest
   vertices) over a 2-shard store on the card with a ``ShardPlanner``, a
   write-ahead log (checkpoint every 4 epochs) and a ``FaultInjector``
   takes the zipf-skewed stream (1,048,576 vertices, 1,000,000 adds an
   epoch, ``delete_frac=0.2``, seed 0) for 6 epochs, 16 queries an epoch
   on the hottest vertices; a seal fault at epoch 3 degrades it and the
   heal catches it up; after the stream the newest split pair is merged
   and 2 more epochs follow. Launch counts are reset just before and read
   just after (``liveness_mask`` must run, ``segment_sum`` once per
   PageRank iteration). Every sealed version equals two CPU oracles (a
   store with the same cutovers forced, under a server without mirrors,
   and a single store), again when rebuilt from the device stamps; every
   answer equals the no-mirror server's on the CPU oracle (at the degraded
   window, its recomputation on the single store); each PageRank run is,
   vertex by vertex, within ``PLANE_PAGERANK_RTOL`` of a float64 rerun
   from its start, and the same run with its contributions kept to bf16
   is not. (b) The log recovered onto the card
   and onto the CPU (plan history, shards, stamp mirrors, every view),
   a crash point past the merge's cutover recovered on the card, then 2
   more epochs into the recovered store. (c) The port's crash-recovery
   demo: ``serve_graph --device cuda`` killed with SIGKILL at epoch 5,
   recovered on the card and audited against a replay on the CPU,
   relaunched with ``--recover``, its final answers over RPC against the
   oracle's. Three faults are planted at 8,192 vertices (split deletes
   kept out of the device stamp mirror, mirrors published one version
   stale, a recovery that skips the plan events); each must fail its
   check. ``python3 tools/probe_phase13.py`` builds the kernels and runs
   this phase alone (no result lines).
14. The reference's examples as the port's entry points
   (``examples/torch_*.py``), each through the function its command line
   calls (``run_demos``). (a) The end-to-end demo on phase 7's store
   (262,144 vertices, 8 epochs of 250,000 preferential-attachment adds,
   4 shards), launch counts reset just before and read just after
   (``liveness_mask`` launched, ``segment_sum`` once per PageRank
   iteration), then again on the CPU path: every integer and id fact
   equal (the straggler's frontier, dispatch, edges per shard, the
   stitched view, 2-hop, reachability, emerging vertices, WCC, hit rates,
   comm bytes, partitions); the stitched view equals the single store
   byte for byte; each PageRank run per vertex within
   ``PLANE_PAGERANK_RTOL`` of a float64 rerun with its bf16 control over
   it; the lineage's top-10 equal to float64's but for swaps within that
   limit. (b) The live demo at that size over 10 unpaced epochs (ingest,
   prewarm and query threads on the card): every k-hop, reachability and
   top-k answer equal to a single-store replay on the CPU, PageRank held
   as in (a), the same launch checks. (c) The RPC quickstart at its own
   sizes, the server a ``serve_graph --device cuda`` subprocess, every
   answer replayed on the CPU. (d) The reference's default model,
   ``qwen2.5-14b`` at full width and depth (48 layers, 14.8 B
   parameters, GQA 5 at hd 128), through phase 9's checks on 4 x 4096 +
   32 (``FAMILY_RUNS``' last entry; its prefill within
   ``FAMILY_PREFILL_RTOL``, 48 ``flash_attention`` launches on
   ``wgmma``), then the batched serving demo's other three reduced models
   (``flash_attention`` on ``simt`` and ``lru_scan`` once a layer; each
   prefill against the plain route within ``MODEL_RTOL``). (e) The
   quickstart and elastic-restart demos (the attention backward
   launched; the first loss within ``FIRST_LOSS_TOL`` of ln(vocab), the
   loss falling; the restart at the newest checkpoint's step, its first
   resumed loss the uninterrupted run's), then ``flash_attention``
   (1e-2) and its backward (``BWD_RTOL_BF16``) against their plain
   versions at each demo's training shapes, (16, 4, 2, 64, 16) and
   (8, 4, 2, 32, 16) in bf16. The kernels line gains the default
   model's ``flash_attention`` row.

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
(2, 4, 4, 4097, 64) causal (1e-2 each); ``decode_attention`` (a decode
step's attention, ``check_decode_attention``) relative to its plain
version's largest output (``DECODE_RTOL``: 3e-2 bf16, 2e-4 float32) at
the main path's decode (48, 40, 8, 2176, 128) at positions 0, 2047 and
2175, at each attention configuration's (G, hd, window) before, at and
past the window's edge, at a batch of 2 over 32,768 positions split as
chosen, unsplit and in 7, and on float32 caches; bit-equal on a second
call; with two planted faults (the mask one position past ``pos``, the
last split left out of the combine) that must exceed the limit. Every
model served (phases 5, 9, 10, 14d) must issue ``decode_attention`` once
per attention layer and decode step the host issues
(:func:`decode_issues`: an eager step once, a step captured in the decode
graph twice, a replayed one not at all), and a model whose decode takes
the graph must capture it once a call and replay it every step; 9 and
14d log it.

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

import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import (  # noqa: E402  the card's peaks
    BF16_TC_FLOPS, FP32_FLOPS, HBM_BW)

N_VERTICES = 1 << 20
# phase 3's stream: 8 epochs (16 until phase 13 joined the run, cut to
# keep the whole run near its time budget)
EPOCHS = 8
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
# decode_attention against its plain version (relative to the output's
# largest magnitude), tests/test_kernels.py's attention tolerances: bf16
# (P rounded once, the output rounded) and float32
DECODE_RTOL = {"bfloat16": 3e-2, "float32": 2e-4}
# the main path's decode: qwen2.5-14b.batch2k (B, Hq, Hkv, capacity, hd)
DECODE_SHAPE = (48, 40, 8, 2176, 128)
# each attention configuration's (B, Hq, Hkv, capacity, hd, window), a
# few sequences a card: G 1 (musicgen), 2 with the local window (gemma3),
# 4 (phi3.5-moe), 6 with the window (mixtral), 8 (qwen1.5, internvl2), 9
# (starcoder2), 10 at hd 256 with the window (recurrentgemma); G 20 and
# 32 (two 16-row groups); hd 16 and 32
DECODE_FAMILY_SHAPES = ((2, 24, 24, 1024, 64, None),
                        (2, 32, 16, 2048, 128, 1024),
                        (2, 32, 8, 1024, 128, None),
                        (1, 48, 8, 8192, 128, 4096),
                        (2, 64, 8, 1024, 128, None),
                        (2, 36, 4, 1024, 128, None),
                        (2, 10, 1, 4096, 256, 2048),
                        (1, 20, 1, 300, 128, None),
                        (1, 32, 1, 512, 64, None),
                        (1, 4, 2, 200, 16, None),
                        (1, 8, 2, 300, 32, 100))
# a long cache at a small batch: the splits carry the card
DECODE_LONG_SHAPE = (2, 40, 8, 32768, 128)
# kernel route vs plain route on the card, relative to each tensor's
# largest magnitude: one layer's mixer on the same input (bf16 output; the
# state in float32), see check_layers_against_plain; the whole prefill,
# see check_model_against_plain
MIXER_RTOL = 1e-2
STATE_RTOL = 1e-5
MODEL_RTOL = 5e-2

# phase 6: the offline plane on a preferential-attachment stream
# 4 epochs (8 until phase 13 joined the run, cut to keep the whole run
# under its time budget)
OFFLINE_N, OFFLINE_EPOCHS, OFFLINE_ADDS = 1 << 20, 4, 1_000_000
PARTS, HUB_K = 16, 64                  # benchmarks/run.py's replica axis
# phase 6's WCC check: the kernel route against the plain route, labels
# compared at each cap (None: the default, 1000 rounds; on the path, whose
# minimum id lies at its far end, WCC_PATH_N + 1: to the end); the star's
# hub takes WCC_STAR in-edges; each fault of WCC_FAULTS must be caught
WCC_CAPS = (1, 2, 3, None)
WCC_PATH_N, WCC_PATH_CAP = 100_000, 50
WCC_STAR = 1 << 20
WCC_FAULTS = ("one buffer as both input and output (in place)",
              "the edge list cut to its first half")
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
# phase 9: the dense-attention and frames families at full width, each as
# (arch, layers run on the card (None: all of them), requests); the bf16
# weights of qwen1.5-110b's 80 layers (~207 GiB) and internvl2-76b's
# (~130 GiB) do not fit 80 GB, so their depth is cut. The last entry is
# the reference's default model (launch/train.py's --arch, the model of
# its quickstart, serve_batched and elastic_restart examples) at full
# width and depth on the batch of its serve_batched example: phase 14d
# runs it through the same machinery (29.5 GB of bf16 weights)
DEFAULT_ARCH = "qwen2.5-14b"
FAMILY_RUNS = (("starcoder2-7b", None, 8), ("gemma3-27b", None, 2),
               ("qwen1.5-110b", 20, 2), ("musicgen-medium", None, 8),
               ("internvl2-76b", 32, 2), (DEFAULT_ARCH, None, 4))
PHASE9_RUNS = tuple(r for r in FAMILY_RUNS if r[0] != DEFAULT_ARCH)
FAMILY_PROMPT, FAMILY_GEN = 4096, 32
# the whole prefill, kernel route against plain, relative to each tensor's
# largest magnitude. (1 + 2^-9)^layers - 1, the rule stated before the
# first run, failed the kernel and a second sound bf16 route alike on
# qwen1.5 and internvl2, and passed P kept to 4 bits on the other three.
# Each limit lies between two readings of its model's prefill on an H100
# (chip_smoke.py): the larger of the kernel route's and the sound route's
# (P rounded once to bf16, rounded_p_attention(SOUND_P_BITS)), and the
# control, P kept to CONTROL_P_BITS significant bits, which must fail;
# each is their geometric mean, to 3 figures. The default model's, by the
# same rule on tools/probe_phase9.py --arch qwen2.5-14b: the sound route's
# 8.30e-2 (the kernel's 7.48e-2) and the control's 3.11e-1
FAMILY_PREFILL_RTOL = {"starcoder2-7b": 2.83e-2, "gemma3-27b": 4.75e-2,
                       "qwen1.5-110b": 1.02e-1, "musicgen-medium": 2.61e-2,
                       "internvl2-76b": 1.51e-1, DEFAULT_ARCH: 1.61e-1}
SOUND_P_BITS, CONTROL_P_BITS = 8, 4
SPLIT_DECODE_STEPS = 4              # decode steps taken apart per model
FAMILY_TRAIN_ARCH = "musicgen-medium"
FAMILY_TRAIN_WARMUP, FAMILY_TRAIN_STEPS = 1, 2
FLASH_FAMILY_TRAIN_SHAPE = (TRAIN_BATCH, 24, 24, TRAIN_SEQ, 64)
# phase 10: the MoE family at full width, each as (arch, layers run on the
# card, requests, prompt); the bf16 weights of mixtral's 56 layers (281 GB)
# and phi3.5-moe's 32 (83.7 GB) do not fit 80 GB, so their depth is cut
MOE_RUNS = (("mixtral-8x22b", 10, 1, 8192),
            ("phi3.5-moe-42b-a6.6b", 20, 2, 4096))
MOE_GEN = 32
# the model whose prefill runs again on the dropping dispatch, at the
# config's capacity_factor, and on a short prompt with moe_groups groups
MOE_DROPPING_ARCH = "mixtral-8x22b"
MOE_CAPACITY, MOE_HIGH_CAPACITY = 1.25, 8.0
MOE_GROUPS, MOE_GROUPS_PROMPT = 4, 2048
# the whole prefill, kernel route against plain, relative to each tensor's
# largest magnitude (max_rel_err), one limit for both models and both
# dispatches, with the plain route's routing replayed on the kernel route
# (routing_tap): a routing flip (a token whose top-k set differs between
# the routes, a legitimate bf16 outcome) changes that token's whole FFN
# output and, with random weights, spreads through the layers after it, so
# the flips are counted and reported, not compared. Set by phase 9's rule
# on the readings of tools/probe_phase10.py on an H100: the geometric mean
# of the largest kernel or sound reading (1.36e-1, phi3.5's sound route)
# and the smallest 4-bit control's (4.06e-1, mixtral's dense prefill), to
# 3 figures
MOE_PREFILL_RTOL = 2.35e-1
# routing layer by layer on the plain route's input: the bf16 router's
# flip share must exceed this many times that of the kernel or the sound
# route (check_routing_layers). tools/probe_phase10.py on an H100 read
# 1.78x (mixtral) and 2.67x (phi3.5); this is the square root of the
# smaller, to 2 figures
BF16_ROUTER_FLIPS = 1.3
# phi3.5-moe trains at full width, cut to 2 layers: 16 bytes a parameter
# of float32 state (weight, gradient, m, v) take 45.8 GB
MOE_TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ = 2, 2048
MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 1, 2
# phase 11: the xLSTM family, xlstm-1.3b at full width and depth (48
# layers, 2.02 B parameters) on its own mLSTM route (mlstm_impl "scan",
# mlstm_chunk 0) through Server.generate, and on the chunkwise route
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_REQUESTS, XLSTM_PROMPT, XLSTM_GEN = 2, 1024, 32
XLSTM_CHUNK = 64
# the chunkwise prefill timed at 4 x 4096, through 4 of the 48 layers (2
# of each kind; the whole depth takes 42 s on the card, a fifth of the
# phase) on a model of its own
XLSTM_LONG = (4, 4096)
XLSTM_LONG_LAYERS = 4
XLSTM_LAYER = (1, 256)                # B x S of the one-layer checks
XLSTM_CONT_PROMPT = 256               # the continuity check's prompt
XLSTM_STEP_REPS = 50                  # calls timed of one cell step
# Limits. Layer by layer, each mixer fed the same input: one full-width
# layer against the same function with its float32 arithmetic in float64
# (check_xlstm_mixers), and each layer of the served model on the
# chunkwise route against the scan route: the output within MIXER_RTOL
# (one bf16 step of the output's rounding, 2.5 allowed) and the float32
# states within this, a float32 recurrence with exp and log (1.7e-6 read
# against float64 on an H100)
XLSTM_STATE_RTOL = 1e-4
# the sLSTM's gelu on its own inputs against the tanh form in float64:
# float32 arithmetic and tanh, a few units in the last place (7e-8 in a
# CPU rehearsal; the exact form reads 7e-5 there)
XLSTM_GELU_RTOL = 1e-6
# layer by layer, a mixer's prefill of P and 32 decode steps against its
# prefill of P + 32 on the same input, palindromic convolution kernels
# (the reference reverses the kernel in decode): the decode's convolution
# is not rounded to bf16 where the prefill's is, up to 2^-9 of the mLSTM's
# q and k over the last 32 steps
XLSTM_CONT_RTOL = 1e-2
# and the decode steps' outputs: MIXER_RTOL, stated first, was met with no
# room at P = 256 (1.00e-2, one layer); this is the rule's limit below
# from tools/probe_phase11.py's readings at P = 256 on an H100: the
# geometric mean of the largest layer's gap (1.00e-2) and the smallest
# layer's control, the decode's outputs kept to 4 significant bits
# (3.54e-2), to 3 figures. Every layer's control must exceed it.
XLSTM_CONT_OUT_RTOL = 1.88e-2
# The whole prefill, chunkwise route against the scan route (the logits
# and every layer's state, relative to each tensor's largest magnitude),
# and the whole model's prefill + decode against its prefill: 5e-2 and
# 1e-1, stated before the first card run, failed (0.412 and 0.601): with
# random weights a float32-level difference grows with depth, as the
# float64 arithmetic's does (0.368). Each is set by the rule in PERF.md
# on tools/probe_phase11.py's readings on an H100: the geometric mean of
# the largest sound reading (the chunkwise route's 0.412; the palindromic
# continuity gap at XLSTM_CONT_PROMPT = 256, 0.601) and the control, each
# mixer's output kept to 4 significant bits (1.511), to 3 figures
XLSTM_ROUTE_RTOL = 7.89e-1
XLSTM_CONT_WHOLE_RTOL = 9.53e-1
# training: full width, cut to 2 layers (an mLSTM and an sLSTM; 4 until
# phase 13 joined the run, cut to pay for its time), chunkwise
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ = 2, 2048
XLSTM_TRAIN_WARMUP, XLSTM_TRAIN_STEPS = 1, 2
# phase 12: the elastic restart at full width, recurrentgemma-2b cut to one
# pattern unit (3 layers: 2 RG-LRU, 1 local attention): 26 layers' float32
# params, m and v make a checkpoint of about 40 GB, one unit's 18.5 GB;
# ELASTIC_STEPS steps of TRAIN_BATCH x TRAIN_SEQ before the checkpoint and
# as many after it
ELASTIC_LAYERS, ELASTIC_STEPS = 3, 2
# the dry-run's predicted peak against the peak measured on the card
# (phase 5's serving run, phase 8c's training run), relative
PEAK_RTOL = 5e-2

# phase 13: the elastic and durable graph plane. 13a: the skewed stream
# (zipf 1.2, delete_frac 0.2, seed 0) of `stream` epochs through a
# planner-carrying store of PLANE_SHARDS shards (the planner settings of
# tests/test_resharding.py's skewed-stream case), a seal fault at
# `fault_epoch`, then the newest split pair merged and PLANE_AFTER_MERGE
# more epochs; 13b: PLANE_AFTER_RECOVERY more epochs into the recovered
# store; 13c: examples/torch_crash_recovery_demo.py at PLANE_CRASH
PLANE_FULL = {"n": 1 << 20, "stream": 6, "adds": 1_000_000, "fault_epoch": 3}
PLANE_SMALL = {"n": 8192, "stream": 4, "adds": 4000, "fault_epoch": 2}
PLANE_AFTER_MERGE, PLANE_AFTER_RECOVERY = 2, 2
PLANE_SHARDS, PLANE_MIRROR_K, PLANE_CKPT_EVERY, PLANE_HOT = 2, 64, 4, 16
PLANE_PLANNER = {"imbalance_threshold": 1.2, "min_load": 100.0,
                 "min_epochs": 2, "max_shards": 8}
PLANE_CRASH = {"vertices": 262_144, "epochs": 10, "adds": 250_000,
               "shards": 4, "seed": 0}
PLANE_CRASH_SMALL = {"vertices": 4096, "epochs": 8, "adds": 4000,
                     "shards": 4, "seed": 0}
# 13a's PageRank: each kernel run against a float64 rerun from the same
# start for the same iterations, vertex by vertex, relative to the float64
# rank (every rank is at least (1 - damping) / n, so no absolute floor is
# needed); the same run with its contributions kept to bf16 (the control)
# must exceed the limit. The limit is the geometric mean, to 3 figures, of
# the sound reading (7.24e-6) and the control's (8.73e-3), read with
# tools/probe_phase13.py on an H100 (see PERF.md)
PLANE_PAGERANK_RTOL = 2.51e-4
PLANE_FAULTS = ("split deletes left out of the stamp mirror",
                "mirrors published one version stale",
                "recovery without the plan events")

# phase 14: the reference's examples as the port's entry points
# (examples/torch_*.py), each driven through the function its command
# line calls. 14a (the end-to-end demo, 8 epochs) and 14b (the live demo,
# 10 epochs, its ingest unpaced as phase 7's is) at phase 7's store size;
# 14c-14e at the demos' own sizes, the reference's; DEMO_SMALL is the
# CPU rehearsal's store
DEMO_GRAPH = {"vertices": RPC_N, "adds": RPC_ADDS, "shards": SHARDS}
DEMO_E2E_EPOCHS, DEMO_LIVE_EPOCHS = 8, 10
DEMO_SMALL = {"vertices": 2048, "adds": 2000, "shards": SHARDS}
# the end-to-end demo's facts that must equal its run on the CPU path; its
# PageRank iterations and top-10 are float32 sums in another order, held
# against a float64 rerun instead
E2E_FACTS = ("author_versions", "author2_fields", "straggler_frontier",
             "dispatched", "edges_per_shard", "global_frontier",
             "stitched_m", "hubs", "two_hop", "reach", "emerging",
             "components", "hit_rate_before", "hit_rate_after",
             "comm_bytes", "sharded_parts", "sharded_placement")
QUERY_KINDS = ("KHop", "Reachability", "DegreeTopK")


# one-element int16 fills that open each profiler window, and the name of
# their kernel (see primed_profile)
PROFILER_PRIMER = 64
PRIMER_KERNEL = "FillFunctor<short>"


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
          ops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time on an H100 SXM for the work, in ms, and what bounds it:
    the bytes over the memory rate or the operations over ``ops_per_s``,
    the card's peak for their type."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class primed_profile:
    """``torch.profiler`` over the card's activity within ``with``, opened
    with PROFILER_PRIMER one-element int16 fills and a synchronise: late in
    a run (phase 6's windows are whole, phase 8a's are not) the profiler
    drops the first device records of a window, 8 to 11 (of 20 launches it
    kept the last 9 or 12, of 5 or 1 mostly none; the host's launches were
    all recorded, and a 50 ms wait before or after them changed nothing),
    and the fills mostly take that loss; now and then a window loses more
    than the fills, or every record (the caller reads that as not
    measured). :meth:`events` gives the window's kernels with device time,
    the fills (PRIMER_KERNEL, a kernel the port does not launch) left
    out."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        primer = self.torch.zeros(1, dtype=self.torch.int16, device="cuda")
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PROFILER_PRIMER):
            primer.fill_(1)
        self.torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self) -> list:
        return [e for e in self.prof.key_averages()
                if e.self_device_time_total > 0
                and PRIMER_KERNEL not in e.key]


def device_ms(torch, fn, kernel, reps: int = 10, per_call: int = 1,
              split: dict | None = None) -> float | None:
    """The kernel's own device time per call in ms, from a
    :class:`primed_profile` window over ``reps`` calls of ``fn`` after a
    warm-up. ``kernel`` is a name, or a tuple of names when a call
    launches several kernels, one of each (``per_call`` launches). Fails if
    anything else ran on the card in that window (every device event must
    be a kernel whose name holds one of the names) or if there were more
    launches than ``per_call`` per call: no helper kernels, no copies. Each
    kernel's time is averaged over the launches of it that the profiler
    saw, and a call's time is the sum of those averages. A window in which
    the profiler recorded none of a kernel of the call is profiled again,
    up to three windows; None (the row says "not measured") only when
    every window missed one, and then the log names what each window saw.
    ``split``, when given, gets each name's own time per launch."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    seen = []
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with primed_profile(torch) as window:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in window.events() if "FillFunctor" not in e.key]
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
               ops_per_s: float = FP32_FLOPS, kernel_route: str = "cuda",
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
    work = lru.work(B, S, C)
    row = kernel_row(
        "lru_scan", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52", max_abs_err=row_err, ms=ms,
        plain_ms=plain, nbytes=work["hbm_bytes"], ops=work["flops"],
        library_ms=None, shape=f"B={B},S={S},C={C},float32", dev_ms=dev)
    row["warps"], row["steps"] = W, T
    row["planted_carry_dropped"] = planted
    row["bit_equal"] = True
    return row


FLASH_SOURCES = {"wgmma": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                            "flash_attention_wgmma_kernel"),
                 "simt": ("src/repro_torch/csrc/flash_attention.cu",
                          "flash_attention_kernel")}


def check_flash_attention(torch) -> tuple[dict, list[dict]]:
    """flash_attention against its plain version at the serving shape and
    at the edge cases (see :func:`flash_attention_case`). Returns the row
    at the main path's shape (bf16, window 2048) and the rows of the other
    cases: the serving shape in float32 (the ``simt`` route, float32
    throughout, so 2e-4; it pins the window edge and the kv-tile skipping)
    and without the window, and the bf16 edge cases: a ragged S with a
    window that is not a multiple of the tile and GQA 4, and S = 4097, one
    row past a tile."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    cases = ((FLASH_SHAPE, torch.bfloat16, FLASH_WINDOW, 1e-2),
             (FLASH_SHAPE, torch.float32, FLASH_WINDOW, 2e-4),
             (FLASH_SHAPE, torch.bfloat16, None, 1e-2),
             ((1, 8, 2, 1024, 128), torch.float32, None, 2e-4),
             ((1, 8, 2, 1000, 128), torch.bfloat16, 300, 1e-2),
             ((2, 4, 4, 4097, 64), torch.bfloat16, None, 1e-2))
    rows = [flash_attention_case(torch, g, *case) for case in cases]
    return rows[0], rows[1:]


def flash_attention_case(torch, g, shape, dtype, window, tol) -> dict:
    """flash_attention at ``shape`` (B, Hq, Hkv, S, hd), causal, on random
    inputs from ``g``, against its plain version (the full S x S softmax
    in float32) within ``tol``, and timed beside the plain version and
    scaled_dot_product_attention with the same mask. The call must launch
    the route that ``route(dtype, hd)`` names: bf16 at hd 64-256 the
    tensor-core kernel (``wgmma``, P rounded to bf16 before the product
    with v, so 1e-2), the rest the CUDA-core kernel (``simt``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    B, Hq, Hkv, S, hd = shape
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
    del want, got

    def kernel():
        return ops.flash_attention(q, k, v, window=window, use_kernel=True)
    source, name = FLASH_SOURCES[which]
    ms = cuda_ms(torch, kernel, reps=10)
    dev = device_ms(torch, kernel, name, reps=5)
    host = host_ms(torch, kernel, reps=20)
    plain = cuda_ms(torch, lambda: ref.flash_attention(
        q, k, v, window=window), reps=5, warmup=1)
    # the library yardstick: SDPA over kv heads expanded to Hq, with the
    # same boolean mask (timed only; the port never calls it)
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
    work = fa.work(B, Hq, Hkv, S, hd, q.element_size(), window)
    return kernel_row(
        "flash_attention", source,
        "src/repro/kernels/flash_attention.py:78", max_abs_err=err,
        ms=ms, plain_ms=plain, nbytes=work["hbm_bytes"], ops=work["flops"],
        library_ms=library,
        shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},hd={hd},"
              f"{str(dtype).split('.')[-1]},window={window}",
        ops_per_s=BF16_TC_FLOPS if dtype == torch.bfloat16
        else FP32_FLOPS, kernel_route=which, dev_ms=dev, host=host)


def decode_positions(cap: int, window) -> tuple:
    """Positions a decode check runs at: the first and the last, and with
    a window the positions before, at and past its edge."""
    if window is None:
        return (0, cap // 2, cap - 1)
    return tuple(sorted({0, window - 2, window - 1, window,
                         min(window + 37, cap - 1), cap - 1}))


def decode_inputs(torch, g, shape, dtype):
    B, Hq, Hkv, cap, hd = shape
    q = torch.randn((B, Hq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, cap, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Hkv, cap, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


def decode_rel_err(got, want) -> float:
    """Largest gap over the plain output's largest magnitude."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def decode_attention_case(torch, q, k, v, pos: int, window,
                          splits=None) -> float:
    """One ``decode_attention`` call against the plain version: its
    relative error (:func:`decode_rel_err`), held to DECODE_RTOL of its
    dtype; the call must launch the kernel once."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, pos, window=window, splits=splits)
    want = ref.decode_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    tol = DECODE_RTOL[str(q.dtype).split(".")[-1]]
    err = decode_rel_err(got, want)
    check(da.decode_attention.launches == before + 1
          and got.dtype == q.dtype and bool(torch.isfinite(got).all()),
          f"decode_attention {tuple(k.shape)} pos {pos}: no launch, dtype "
          "or non-finite")
    check(err <= tol, f"decode_attention {tuple(q.shape)} over "
                      f"{tuple(k.shape)} {q.dtype} pos {pos} window {window} "
                      f"splits {splits}: relative error {err:.3e} over {tol}")
    return err


def decode_split_left_out(torch, q, k, v, pos: int, splits: int) -> float:
    """The planted fault of the combine: the splits' partials written by
    the raw C entry, the last split's weight set to 0 (max -inf, sum 0),
    then the combine launch alone; its relative error to the plain
    version."""
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels import decode_attention as da

    B, Hq, hd = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    rows = da.ROWS[q.dtype]
    part = torch.empty(da.partial_floats(q.dtype, B, Hq, Hkv, hd, splits),
                       dtype=torch.float32, device="cuda")
    out = torch.empty_like(q)
    lib = _lib.load()
    dtype = da._DTYPES[q.dtype]
    stream = _lib.stream_of(q)
    at = torch.full((1,), pos, dtype=torch.int32, device="cuda")
    _lib.check(lib.rt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, part.data_ptr(),
        at.data_ptr(), dtype, B, Hq, Hkv, cap, hd, 0, splits, hd ** -0.5,
        stream), "decode_attention (partials)")
    last = part.view(-1, splits, rows, hd + 2)[:, -1]
    last[..., hd] = float("-inf")
    last[..., hd + 1] = 0.0
    _lib.check(lib.rt_decode_attention_combine(
        part.data_ptr(), out.data_ptr(), dtype, B, Hq, Hkv, hd, splits,
        stream), "decode_attention (combine)")
    want = ref.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    return decode_rel_err(out, want)


def check_decode_attention(torch) -> tuple[dict, list[dict]]:
    """decode_attention against its plain version
    (:func:`decode_attention_case`): at the main path's shape
    (DECODE_SHAPE, bf16) at positions 0, 2047 and 2175; each attention
    configuration's (G, hd, window) (DECODE_FAMILY_SHAPES) at
    :func:`decode_positions`; a batch of 2 over a 32,768-position cache
    (DECODE_LONG_SHAPE), whose splits carry the card, at its chosen split
    count, at one split and at 7; float32 caches. Two calls must be
    bit-equal. Two planted faults must exceed the tolerance: the mask one
    position past ``pos`` (the kernel at pos + 1 against the plain
    version at pos, early in the cache, where one position weighs), and
    the last split left out of the combine (:func:`decode_split_left_out`).
    Returns the row at the main path's shape at pos 2175, timed beside the
    plain version and scaled_dot_product_attention (GQA, the same mask),
    and a row of the long cache."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 30)
    errs: dict = {}
    planted: dict = {}
    bf16 = torch.bfloat16
    q, k, v = decode_inputs(torch, g, DECODE_SHAPE, bf16)
    for pos in (0, 2047, 2175):
        errs[f"{DECODE_SHAPE} bf16 pos {pos}"] = decode_attention_case(
            torch, q, k, v, pos, None)
    a = da.decode_attention(q, k, v, 2175)
    b = da.decode_attention(q, k, v, 2175)
    check(bool(torch.equal(a, b)), "decode_attention: two calls differ")
    planted["mask one past pos"] = decode_rel_err(
        da.decode_attention(q, k, v, 4), ref.decode_attention(q, k, v, 3))
    del a, b
    main = decode_row(torch, F, q, k, v, 2175, None)
    del q, k, v
    for B, Hq, Hkv, cap, hd, window in DECODE_FAMILY_SHAPES:
        q, k, v = decode_inputs(torch, g, (B, Hq, Hkv, cap, hd), bf16)
        for pos in decode_positions(cap, window):
            errs[f"{(B, Hq, Hkv, cap, hd)} bf16 window {window} pos {pos}"] \
                = decode_attention_case(torch, q, k, v, pos, window)
    q, k, v = decode_inputs(torch, g, DECODE_LONG_SHAPE, bf16)
    B, Hq, Hkv, cap, hd = DECODE_LONG_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = da.split_count(bf16, B, Hq, Hkv, hd, cap, sms)
    for splits in (None, 1, 7):
        errs[f"{DECODE_LONG_SHAPE} bf16 pos {cap - 1} splits "
             f"{splits or chosen}"] = decode_attention_case(
            torch, q, k, v, cap - 1, None, splits)
    planted["last split left out"] = decode_split_left_out(
        torch, q, k, v, cap - 1, 4)
    long_row = decode_row(torch, F, q, k, v, cap - 1, None)
    del q, k, v
    for shape, window, pos in (((2, 8, 2, 1000, 128), None, 999),
                               ((1, 10, 1, 4096, 256), 2048, 3000),
                               ((1, 4, 2, 5000, 16), 300, 4999),
                               ((2, 40, 8, 2176, 128), None, 2175)):
        q, k, v = decode_inputs(torch, g, shape, torch.float32)
        errs[f"{shape} float32 window {window} pos {pos}"] = \
            decode_attention_case(torch, q, k, v, pos, window)
    del q, k, v
    for name, err in planted.items():
        check(err > DECODE_RTOL["bfloat16"],
              f"decode_attention planted fault {name!r} not caught: "
              f"{err:.3e}")
    main["errors"] = errs
    main["planted"] = planted
    return main, [long_row]


def decode_row(torch, F, q, k, v, pos: int, window) -> dict:
    """The kernels-table row of one ``decode_attention`` shape, called as
    the model's decode step calls it (the position as device data, the
    split count the capacity's): the kernel's CUDA-event and device time
    (the attention kernel and, with splits, the combine), host time, the
    plain version's and SDPA's."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    B, Hq, hd = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    at = torch.full((1,), pos, dtype=torch.int32, device=q.device)

    def kernel():
        return da.decode_attention(q, k, v, at, window=window)
    start, length = da.attended(pos, window)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = da.split_count(q.dtype, B, Hq, Hkv, hd,
                            da.attended(cap - 1, window)[1], sms)
    names = ("decode_attention_kernel_mma",) + (
        ("decode_attention_kernel_combine",) if splits > 1 else ())
    ms = cuda_ms(torch, kernel, reps=20)
    dev = device_ms(torch, kernel, names, reps=10, per_call=len(names))
    host = host_ms(torch, kernel, reps=50)
    plain = cuda_ms(torch, lambda: ref.decode_attention(
        q, k, v, pos, window=window), reps=5, warmup=1)
    idx = torch.arange(cap, device="cuda")
    mask = ((idx >= start) & (idx <= pos))[None, :]
    q4 = q[:, :, None]
    library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True), reps=10)
    work = da.work(B, Hq, Hkv, length, hd, q.element_size())
    return kernel_row(
        "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "none (the reference's decode attention is an einsum, "
        "src/repro/nn/attention.py:193-203)", max_abs_err=None, ms=ms,
        plain_ms=plain, nbytes=work["hbm_bytes"], ops=work["flops"],
        library_ms=library,
        shape=f"B={B},Hq={Hq},Hkv={Hkv},capacity={cap},hd={hd},pos={pos},"
              f"{str(q.dtype).split('.')[-1]},window={window}",
        ops_per_s=BF16_TC_FLOPS, kernel_route="mma", dev_ms=dev,
        host=host) | {"splits": splits}


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
def decode_issues(counts: dict, steps: int) -> int:
    """Of ``steps`` decode steps, how many times the host issued a step's
    kernels, by the decode graph's counts in ``counts``
    (``ops.graph_counts()``): an eager step once, a captured step twice
    (the eager warm-up, then the capture), a replay not at all."""
    return steps - counts.get("decode_graph.replays", 0) \
        + 2 * counts.get("decode_graph.captures", 0)


def serve_model(torch, cfg, device: str = "cuda",
                requests: int = MODEL_REQUESTS, prompt: int = MODEL_PROMPT,
                gen: int = MODEL_GEN) -> dict:
    """``cfg`` (random weights from seed 0) served on ``requests`` inputs
    from NumPy seed 0: a token model through ``Server.generate`` (``gen``
    greedy tokens), a frames model, which ``Server.generate`` refuses,
    through :func:`generate_frames` (``gen`` decode steps on seeded
    frames). The kernels' launches are counted around it: each RG-LRU
    layer must have launched ``lru_scan`` once and each attention layer
    ``flash_attention`` once, on its tensor-core (``wgmma``) route, and
    ``decode_attention`` once a decode step the host issued
    (:func:`decode_issues`), a model that takes the decode graph
    capturing it once and replaying it every step; the attention calls
    are also tallied by shape (:class:`attention_shapes`)."""
    import numpy as np

    from repro_torch.configs import ATTN_KINDS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import takes_graph
    from repro_torch.models import transformer as tf

    t = time.perf_counter()
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    model = tf.init_params(cfg, g, device)
    sync(torch, device)
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED)
    frames = cfg.embed_mode == "frames"
    if frames:
        prompts = rng.standard_normal(
            (requests, prompt, cfg.d_model)).astype(np.float32)
        step_frames = rng.standard_normal(
            (gen, requests, 1, cfg.d_model)).astype(np.float32)
    else:
        prompts = rng.integers(0, cfg.vocab_size,
                               (requests, prompt)).astype(np.int32)
        server = Server(cfg, model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated() if device == "cuda" else 0
    ops.reset_launch_counts()
    with attention_shapes() as shapes:
        if frames:
            out, timings = generate_frames(torch, model, cfg, prompts,
                                           step_frames)
        else:
            out = server.generate(prompts, gen)
            timings = server.timings
    sync(torch, device)
    counts = ops.launch_counts() | ops.graph_counts()
    routes = ops.route_counts()["flash_attention"]
    kinds = [k for _, k in model.blocks()]
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    on_card = device == "cuda"
    graphed = on_card and takes_graph(cfg, device)
    want = {"lru_scan": kinds.count("rglru") if on_card else 0,
            "flash_attention": n_attn if on_card else 0,
            "decode_attention": (n_attn * decode_issues(counts, gen)
                                 if on_card else 0),
            "decode_graph.captures": int(graphed),
            "decode_graph.replays": gen if graphed else 0}
    for name, n in want.items():
        check(counts[name] == n,
              f"{name} launched {counts[name]} times, expected {n}")
    # bf16 at head dim 64-256: every attention layer takes the tensor cores
    check(routes["wgmma"] == want["flash_attention"],
          f"flash_attention routes {routes}, expected "
          f"{want['flash_attention']} wgmma launches")
    check(sum(shapes.calls.values()) == n_attn,
          f"attention calls by shape {shapes.calls}")
    check(out.shape == (requests, gen) and out.dtype == np.int32
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generated tokens of shape {out.shape}, dtype {out.dtype}")
    run = {"cfg": cfg, "model": model, "prompts": prompts, "out": out,
           "counts": counts, "routes": routes, "shapes": shapes.calls,
           "init_s": init_s, "timings": timings,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if on_card else None),
           # allocated at the reset: the weights and what earlier phases
           # left
           "base_bytes": base_bytes,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
           "params": sum(p.numel() for p in model.parameters())}
    if frames:
        run["step_frames"] = step_frames
    return run


def generate_frames(torch, model, cfg, prompts, step_frames):
    """The frames counterpart of ``Server.generate``: ``tf.prefill`` on
    (B, P, D) ``prompts``, then one ``launch.steps.make_decode_step`` call
    per (B, 1, D) frame of ``step_frames`` (G, B, 1, D), each at its
    position. Returns the argmax code of every step's logits, (B, G) int32
    (from the prefill's logits, then each decode step's but the last), and
    the prefill and decode seconds, each ending in a synchronise; every
    logit must be finite."""
    from repro_torch.device import to_host
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf

    decode = make_decode_step(cfg)
    dev = model.device
    B, P = prompts.shape[:2]
    gen = step_frames.shape[0]
    with torch.inference_mode():
        x = torch.from_numpy(prompts).to(dev)
        steps_in = torch.from_numpy(step_frames).to(dev)
        sync(torch, dev.type)
        t0 = time.perf_counter()
        logits, cache = tf.prefill(model, cfg, x, capacity=P + gen)
        sync(torch, dev.type)
        t1 = time.perf_counter()
        codes = torch.zeros((B, gen), dtype=torch.int32, device=dev)
        finite = torch.isfinite(logits).all()
        for t in range(gen):
            codes[:, t] = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            logits, cache = decode(model, cache, steps_in[t], P + t)
            finite = finite & torch.isfinite(logits).all()
        host = to_host(codes)
        t2 = time.perf_counter()
    check(bool(finite), f"{cfg.name}: non-finite frame logits")
    return host, {"prefill_s": t1 - t0, "decode_s": t2 - t1}


class attention_shapes:
    """Within ``with``, tallies the model path's calls of
    ``ops.flash_attention`` by (B, Hq, Hkv, S, hd, window) in ``calls``;
    on a card each is one kernel launch."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real, self.calls = ops, ops.flash_attention, {}

        def tallied(q, k, v, **kw):
            key = (*q.shape[:2], k.shape[1], *q.shape[2:], kw.get("window"))
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.real(q, k, v, **kw)
        ops.flash_attention = tallied
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


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


class swapped:
    """Within ``with``, attribute ``name`` of ``target`` is ``value``."""

    def __init__(self, target, name: str, value):
        self.target, self.name, self.value = target, name, value

    def __enter__(self):
        self.real = getattr(self.target, self.name)
        setattr(self.target, self.name, self.value)
        return self

    def __exit__(self, *exc):
        setattr(self.target, self.name, self.real)


def late_b(args, kw):
    """lru_scan with b_t read one step late."""
    a, b = args[:2]
    return (a, b.roll(1, 1)) + args[2:], kw


def window_to(window):
    def alter(args, kw):
        return args, {**kw, "window": window}
    return alter


def causal_off(args, kw):
    """flash_attention with the causal mask off: keys after the query
    attend too."""
    return args, {**kw, "causal": False}


def kv_heads_rolled(args, kw):
    """flash_attention with the kv heads rolled by one along the head
    axis: each group of query heads reads its neighbour's keys and
    values."""
    q, k, v = args[:3]
    return (q, k.roll(1, 1), v.roll(1, 1)) + args[3:], kw


KV_TILE = 64                  # the kernels' kv tile (flash_attention*.cu)


def attention_faults(cfg, kind: str) -> dict:
    """Faults to plant in the kernel route of an attention layer of
    ``kind``, each one changing the layer's function: the causal mask off;
    with more than one kv head, the kv heads rolled by one; with a window,
    the window dropped and, where the window is longer than a kv tile, the
    window one kv tile short."""
    from repro_torch.nn import attention as attn

    faults = {"causal off": causal_off}
    if cfg.n_kv_heads > 1:
        faults["kv heads rolled"] = kv_heads_rolled
    window = attn.window_for(kind, cfg)
    if window is not None:
        faults["window dropped"] = window_to(None)
        if window > KV_TILE:
            faults["window one kv tile short"] = window_to(window - KV_TILE)
    return faults


def round_to_bits(torch, x, bits: int):
    """float32 ``x`` rounded in place to ``bits`` significant bits, to
    nearest even (bf16 keeps 8: ``round_to_bits(x, 8)`` equals
    ``x.bfloat16().float()`` for finite ``x``)."""
    drop = 24 - bits
    i = x.view(torch.int32)
    i.add_(((1 << (drop - 1)) - 1) + ((i >> drop) & 1))
    i.bitwise_and_(~((1 << drop) - 1))
    return x


def rounded_p_attention(torch, bits: int, block: int = 1024):
    """A stand-in for ``ops.flash_attention`` on the model path: per block
    of ``block`` queries the exact float32 softmax over the keys it may
    see, the probabilities P rounded to ``bits`` significant bits, then
    the product with v in float32 and the output in q's dtype. With 8
    bits this is another sound bf16 route (P normalised, then rounded
    once, as neither the kernel nor the plain route does); with fewer it
    is the control a prefill limit must catch: a route that keeps less
    of P than bf16 does."""
    def attend(q, k, v, *, causal=True, window=None, use_kernel=None):
        check(causal, "rounded_p_attention is causal only")
        B, Hq, S, hd = q.shape
        Hkv = k.shape[1]
        out = torch.empty_like(q)
        og = out.view(B, Hkv, Hq // Hkv, S, hd)
        qg = q.view(B, Hkv, Hq // Hkv, S, hd)
        pos = torch.arange(S, device=q.device)
        for lo_q in range(0, S, block):
            hi = min(S, lo_q + block)
            lo = 0 if window is None else max(0, lo_q - window + 1)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, lo_q:hi]
                             .float(), k[:, :, lo:hi].float()) * hd ** -0.5
            d = pos[lo_q:hi, None] - pos[None, lo:hi]
            mask = d >= 0 if window is None else (d >= 0) & (d < window)
            s.masked_fill_(~mask, -1e30)
            p = round_to_bits(torch, torch.softmax(s, dim=-1), bits)
            del s
            og[:, :, :, lo_q:hi] = torch.einsum(
                "bhgqk,bhkd->bhgqd", p, v[:, :, lo:hi].float()).to(q.dtype)
            del p
        return out
    return attend


def check_layers_against_plain(torch, run: dict) -> dict:
    """Each layer's mixer through the kernels (``use_kernel=None``, as the
    model path calls them) and through the plain versions, both fed the
    plain route's hidden state, so that no error carries over from the
    layers before (tokens or frames, as the run was fed). Both round their
    bf16 output once from float32 values
    that differ in the last bits (the attention's float32 sums taken in
    another order and its bf16 probabilities rounded from them; the scan's
    one FMA against a product and a sum), so the outputs may differ by one
    bf16 step (2^-8 of the largest magnitude): MIXER_RTOL allows 2.5 steps.
    The RG-LRU state is the scan's float32 output, held to STATE_RTOL.
    Planted faults in the first layer of each kind must exceed the limits:
    the scan's ``b`` one step late (RG-LRU) and :func:`attention_faults`."""
    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention as attn
    from repro_torch.nn import recurrent as rec
    from repro_torch.nn.layers import apply_norm

    cfg, model = run["cfg"], run["model"]
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    B, S = prompts.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=model.device)[
        None].expand(B, S)
    faults = {kind: ({"b one step late": late_b} if kind == "rglru"
                     else attention_faults(cfg, kind))
              for kind in dict.fromkeys(k for _, k in model.blocks())}

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
            for name, alter in faults.pop(kind, {}).items():
                with planted("lru_scan" if kind == "rglru"
                             else "flash_attention", alter):
                    planted_errs[f"layer{i} {name}"] = errors(
                        mixer(block, kind, h, None), plain)
            x, _, _ = tf.apply_block(block, x, cfg, kind, positions, False)
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


def prefill_errors(torch, cfg, got, want) -> dict:
    """max_rel_err of a prefill's last-position logits and of every
    layer's cache against another prefill's."""
    from repro_torch.models import transformer as tf

    (g_logits, g_cache), (w_logits, w_cache) = got, want
    errs = {"logits": max_rel_err(torch, g_logits, w_logits)}
    for i, (gc, wc) in enumerate(zip(tf.layer_caches(cfg, g_cache),
                                     tf.layer_caches(cfg, w_cache),
                                     strict=True)):
        for name in gc:
            errs[f"layer{i}.{name}"] = max_rel_err(torch, gc[name], wc[name])
    return errs


def check_model_against_plain(torch, run: dict, gen: int = MODEL_GEN,
                              rtol: float = MODEL_RTOL,
                              faults: dict | None = None,
                              sound: dict | None = None,
                              controls: dict | None = None) -> dict:
    """The prefill through the kernels against the same prefill through the
    plain versions, both on the card in bf16. The two routes round at other
    places (both round the attention probabilities to bf16 before the
    product with v, but from float32 sums taken in another order; the
    scan's FMA rounds once where the plain loop rounds twice); the
    differences enter the bf16 residual stream and compound over the
    layers, so each tensor is held to ``rtol`` of its largest magnitude
    (MODEL_RTOL over recurrentgemma's 26 layers; FAMILY_PREFILL_RTOL).
    Each of ``faults`` ({name: alter}), planted in every attention layer
    of a kernel prefill, must exceed ``rtol``. ``sound`` and ``controls``
    ({name: attend}) each stand in for ``ops.flash_attention`` in a whole
    prefill: a sound route must stay within ``rtol`` of the plain one as
    the kernel's must, and a control (a route that keeps less of the
    attention than bf16 does) must exceed it."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    cfg, model = run["cfg"], run["model"]
    device = model.device.type
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    capacity = prompts.shape[1] + gen
    with torch.inference_mode():
        t = time.perf_counter()
        kernel = tf.prefill(model, cfg, prompts, capacity)
        sync(torch, device)
        kernel_s = time.perf_counter() - t
        t = time.perf_counter()
        plain = tf.prefill(model, cfg, prompts, capacity, use_kernel=False)
        sync(torch, device)
        plain_s = time.perf_counter() - t
    check(tuple(kernel[0].shape) == (prompts.shape[0], 1, cfg.vocab_size),
          f"logits shape {tuple(kernel[0].shape)}")
    errs = prefill_errors(torch, cfg, kernel, plain)
    del kernel
    worst = max(errs, key=errs.get)
    check(errs[worst] <= rtol,
          f"kernel prefill vs plain: {worst} off by {errs[worst]} of its "
          f"largest magnitude (limit {rtol})")
    planted_errs = {}
    for name, alter in (faults or {}).items():
        with torch.inference_mode(), planted("flash_attention", alter):
            bad = tf.prefill(model, cfg, prompts, capacity)
        planted_errs[name] = max(prefill_errors(torch, cfg, bad,
                                                plain).values())
        del bad
    missed = [n for n, e in planted_errs.items() if e <= rtol]
    check(not missed, f"prefill planted faults not caught: {missed} "
                      f"{planted_errs} (limit {rtol})")
    stand_in = {}
    for name, attend in {**(sound or {}), **(controls or {})}.items():
        with swapped(ops, "flash_attention", attend), torch.inference_mode():
            other = tf.prefill(model, cfg, prompts, capacity)
        stand_in[name] = max(prefill_errors(torch, cfg, other,
                                            plain).values())
        del other
    over = [n for n in sound or {} if stand_in[n] > rtol]
    check(not over, f"sound prefill routes over the limit: {over} "
                    f"{stand_in} (limit {rtol})")
    missed = [n for n in controls or {} if stand_in[n] <= rtol]
    check(not missed, f"prefill controls not caught: {missed} {stand_in} "
                      f"(limit {rtol})")
    n_layers = len(tf.layer_caches(cfg, plain[1]))
    per_layer = [max(v for k, v in errs.items() if k.startswith(f"layer{i}."))
                 for i in range(n_layers)]
    return {"kernel_prefill_s": kernel_s, "plain_prefill_s": plain_s,
            "logits_rel_err": errs["logits"], "worst": worst,
            "worst_rel_err": errs[worst], "per_layer": per_layer,
            "limit": rtol, "planted": planted_errs, "stand_in": stand_in}


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


def edge_view(torch, src, dst, n: int, device: str):
    """A ``JoinView`` of the edges (``src``, ``dst``) (NumPy ids), rows in
    the store's (dst, src) order, on ``device``."""
    import numpy as np

    from repro_torch.core.versioned import Version
    from repro_torch.graph.dyngraph import build_join_view

    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    return build_join_view(Version(0, 0), n, (dst << 32) | src, src, dst,
                           np.bincount(dst, minlength=n),
                           np.bincount(src, minlength=n), device=device)


def wcc_graphs(torch, view) -> dict:
    """{name: (view, caps)} for :func:`check_wcc_kernel`: ``view``; a path
    whose ids fall along it (the least id, 0, travels one hop a round from
    the far end); a star of ``WCC_STAR`` in-edges into its largest id (one
    hub segment across thousands of warps); a graph of self-loops and
    duplicate edges; a graph without edges."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    path = np.arange(WCC_PATH_N - 1, 0, -1)
    pairs = rng.integers(0, 5000, (20_000, 2))
    loops = rng.integers(0, 5000, 3000)
    dup_src = np.concatenate([np.repeat(pairs[:, 0], 3), loops])
    dup_dst = np.concatenate([np.repeat(pairs[:, 1], 3), loops])
    return {
        "view": (view, WCC_CAPS),
        "path": (edge_view(torch, path, path - 1, WCC_PATH_N, "cuda"),
                 (1, 2, 3, WCC_PATH_CAP, WCC_PATH_N + 1)),
        "star": (edge_view(torch, np.arange(WCC_STAR),
                           np.full(WCC_STAR, WCC_STAR), WCC_STAR + 1,
                           "cuda"), WCC_CAPS),
        "loops and duplicates": (edge_view(torch, dup_src, dup_dst, 5000,
                                           "cuda"), WCC_CAPS),
        "no edges": (edge_view(torch, [], [], 1000, "cuda"), WCC_CAPS),
    }


def wcc_rounds(torch, fn):
    """``fn()`` (one ``compute.wcc`` call) under a CPU profiler, so the
    program's spans record: (its labels, its ``Compute.wcc`` span's
    rounds and route)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            labels = fn()
        (call,) = [s for s in trace.spans() if s.name == "Compute.wcc"]
    finally:
        trace.clear()
    return labels, call.attrs["rounds"], call.attrs["route"]


def compare_wcc(torch, graphs: dict, first: bool = False):
    """Every graph of ``graphs`` at each of its caps through ``compute.wcc``
    on the kernel route and on the plain route: (the mismatches, one row
    per comparison). Stops at the first mismatch when ``first``. On the
    path without a binding cap the plain route takes WCC_PATH_N rounds
    (its minimum id moves one hop a round) and runs unprofiled."""
    from repro_torch.graph import compute as gc
    from repro_torch.kernels import ops

    bad, rows = [], {}
    for name, (g, caps) in graphs.items():
        for cap in caps:
            kw = {} if cap is None else {"max_rounds": cap}
            ops.reset_launch_counts()
            t = time.perf_counter()
            got = gc.wcc(g, **kw)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t
            launches = ops.launch_counts()["wcc_round"]
            t = time.perf_counter()
            if cap == WCC_PATH_N + 1:
                want, rounds, route = gc.wcc(g, use_kernel=False, **kw), \
                    WCC_PATH_N, "plain"
            else:
                want, rounds, route = wcc_rounds(
                    torch, lambda: gc.wcc(g, use_kernel=False, **kw))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t
            key = f"{name} cap {cap or 'default'}"
            check(route == "plain", f"WCC {key}: the plain call's route "
                                    f"is {route}")
            differ = int((got != want).sum())
            if got.dtype != torch.int32 or want.dtype != torch.int32 \
                    or differ or launches != rounds:
                bad.append(f"{key}: {differ} labels differ, {launches} "
                           f"launches against {rounds} plain rounds")
                if first:
                    return bad, rows
            rows[key] = {"m": g.m, "rounds": rounds, "launches": launches,
                         "kernel_s": round(kernel_s, 4),
                         "plain_s": round(plain_s, 4)}
    return bad, rows


@contextlib.contextmanager
def wcc_in_place(torch):
    """Within ``with``, ``ops.wcc_round`` calls the raw C entry with one
    buffer as input and output: a round then reads labels lowered earlier
    in the same round (propagation within the round), which the wrapper
    refuses. Its launches count as the wrapper's would."""
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import wcc as cuda_wcc

    real = ops.wcc_round

    def faulty(src, dst, labels, *, out, changed, use_kernel):
        out.copy_(labels)
        code = _lib.load().rt_wcc_round(
            src.data_ptr(), dst.data_ptr(), src.shape[0], out.data_ptr(),
            out.data_ptr(), out.shape[0], changed.data_ptr(),
            _lib.stream_of(out))
        _lib.check(code, "wcc_round")
        cuda_wcc.wcc_round.launches += 1
        return out, changed
    ops.wcc_round = faulty
    try:
        yield
    finally:
        ops.wcc_round = real


def check_wcc_kernel(torch, view) -> dict:
    """WCC's kernel route (one ``wcc_round`` launch a round) against its
    plain route (``use_kernel=False``) on the card: bit-equal int32 labels
    at every cap of :func:`wcc_graphs`, the kernel's launches equal to the
    plain route's rounds. Each of ``WCC_FAULTS`` must be caught."""
    graphs = wcc_graphs(torch, view)
    bad, rows = compare_wcc(torch, graphs)
    check(not bad, f"WCC: the kernel route differs from the plain route: "
                   f"{bad}")
    faults = {WCC_FAULTS[0]: lambda: wcc_in_place(torch),
              WCC_FAULTS[1]: lambda: planted("wcc_round", lambda a, kw: (
                  (a[0][:a[0].shape[0] // 2], a[1][:a[1].shape[0] // 2],
                   *a[2:]), kw))}
    caught = {}
    for name, fault in faults.items():
        with fault():
            found, _ = compare_wcc(torch, graphs, first=True)
        check(bool(found), f"planted WCC fault not caught: {name}")
        caught[name] = found[0]
    return {"compared": rows, "planted": caught}


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
    """flash_attention_bwd against its plain version (see
    :func:`flash_attention_bwd_case`) at the training shape and at the
    forward's other shapes. Returns the training shape's row and the
    others."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = ((FLASH_TRAIN_SHAPE, bf16, FLASH_WINDOW, BWD_RTOL_BF16),
             ((1, 8, 2, 1024, 128), f32, None, BWD_RTOL_F32),
             ((2, 4, 2, 64, 16), bf16, None, BWD_RTOL_BF16),
             ((1, 8, 2, 1000, 128), bf16, 300, BWD_RTOL_BF16),
             ((2, 4, 4, 4097, 64), bf16, None, BWD_RTOL_BF16))
    rows = [flash_attention_bwd_case(torch, g, *case) for case in cases]
    return rows[0], rows[1:]


def flash_attention_bwd_case(torch, g, shape, dtype, window, tol) -> dict:
    """flash_attention_bwd at ``shape`` (B, Hq, Hkv, S, hd) on random
    inputs from ``g`` against its plain version (the full S x S softmax
    gradient in float32), fed the same forward output and lse, within
    ``tol`` of each gradient's largest magnitude. The call must launch the
    route that ``route(dtype, hd)`` names (bf16 at hd 64-256 the
    tensor-core kernels, ``wgmma``; the rest ``simt``); a ``wgmma`` call
    must give the same bits on a second call. Planted faults must exceed
    the limit: the lse one row off; with a window, the window one kv tile
    short; with a group of query heads, the last head of each group left
    out of the walk (its dO zeroed, which is what a dK/dV walk one head
    short and a dQ pass without that head give). Timed beside the plain
    version and SDPA's backward with the same boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    bf16 = torch.bfloat16
    B, Hq, Hkv, S, hd = shape
    q, k, v, do = (torch.randn(dims, generator=g, device="cuda").to(dtype)
                   for dims in ((B, Hq, S, hd), (B, Hkv, S, hd),
                                (B, Hkv, S, hd), (B, Hq, S, hd)))
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
    work = fa.work(B, Hq, Hkv, S, hd, q.element_size(), window,
                   backward=True)
    row = kernel_row(
        "flash_attention_bwd", source,
        "src/repro/kernels/flash_attention.py:78", max_abs_err=err,
        ms=ms, plain_ms=plain, nbytes=work["hbm_bytes"], ops=work["flops"],
        library_ms=library,
        shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},hd={hd},"
              f"{str(dtype).split('.')[-1]},window={window}",
        ops_per_s=BF16_TC_FLOPS if dtype == bf16 else FP32_FLOPS,
        kernel_route=which, dev_ms=dev)
    row["device_ms_split"] = dev_split
    row["planted"] = planted_errs
    row["limit"] = tol
    row["bit_equal"] = bit_equal
    return row


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
    work = lru.work(B, S_train, C, backward=True)
    shape = f"B={B},S={S_train},C={C},float32"
    row = kernel_row(
        "lru_scan_bwd", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52",
        max_abs_err=errs[f"S={S_train},h0=False"], ms=ms, plain_ms=plain,
        nbytes=work["hbm_bytes"], ops=work["flops"], library_ms=None,
        shape=shape, dev_ms=dev)
    row["device_ms_split"] = dev_split
    row["planted"] = {k: e for k, e in planted_errs.items()
                      if k.startswith(f"S={S_train},")}
    row["limit"] = LRU_BWD_RTOL
    row["bit_equal"] = True
    work = lru.work(B, S_train, C)
    fwd_row = kernel_row(
        "lru_scan", "src/repro_torch/csrc/lru_scan.cu",
        "src/repro/kernels/lru_scan.py:52", max_abs_err=fwd["err"],
        ms=fwd["ms"], plain_ms=fwd["plain"], nbytes=work["hbm_bytes"],
        ops=work["flops"], library_ms=None, shape=shape + " (training)",
        dev_ms=fwd["dev"])
    return row, fwd_row


def training_batch(cfg, index: int, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ) -> dict:
    """Batch ``index`` of the training pipeline (Markov data, seed 0; a
    frames model's inputs are seeded (batch, seq, d_model) frames), as
    ``launch.train.run`` makes it."""
    from repro_torch.train.data import TokenPipeline

    return TokenPipeline(
        cfg.vocab_size, batch, seq, seed=SEED,
        frames_dim=cfg.d_model if cfg.embed_mode == "frames" else None,
    ).batch_view(index).value()


def check_training_gradients(torch, cfg, device: str = "cuda",
                             batch: int = TRAIN_BATCH,
                             seq: int = TRAIN_SEQ) -> dict:
    """One unit of ``cfg`` at full width (recurrentgemma's 3 layers, one
    layer of a model whose pattern is one attention kind): the loss and
    every parameter's gradient through the kernel route (forward and
    backward kernels) against the plain route (autograd of the plain
    versions), both on the card from the same float32 master weights (seed
    0) and batch (tokens or frames). Each gradient within GRAD_RTOL of its
    largest magnitude (bf16 compute on both routes, rounded at other
    places); faults planted in the backward kernels must exceed it: the
    attention backward with the causal mask off and, where the unit has a
    window, without it; the scan backward, where the unit has RG-LRU
    layers, with dh one step late."""
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
    from repro_torch.nn import attention as attn

    faults = {"attention backward with the causal mask off": planted(
        "flash_attention_bwd", causal_off, fa)}
    if any(attn.window_for(k, cfg) is not None for k in cfg.pattern):
        faults["attention backward without its window"] = planted(
            "flash_attention_bwd", window_to(None), fa)
    if "rglru" in cfg.pattern:
        faults["scan backward with dh one step late"] = planted(
            "lru_scan_bwd", lambda args, kw: (
                args[:2] + (args[2].roll(1, 1),) + args[3:], kw), lru)
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
    from repro_torch.configs import ATTN_KINDS

    unit = list(cfg.pattern) * cfg.num_units
    tail = list(cfg.tail_pattern)
    rg_u, rg_t = unit.count("rglru"), tail.count("rglru")
    at_u = sum(k in ATTN_KINDS for k in unit)
    at_t = sum(k in ATTN_KINDS for k in tail)
    return {"lru_scan": 2 * rg_u + rg_t, "lru_scan_bwd": rg_u + rg_t,
            "flash_attention": 2 * at_u + at_t,
            "flash_attention_bwd": at_u + at_t}


def train_model(torch, cfg, device: str = "cuda", batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, warmup: int = TRAIN_WARMUP,
                steps: int = TRAIN_STEPS) -> dict:
    """The main path of phase 8: ``launch.train.run`` on ``cfg`` at full
    width and depth, ``warmup`` + ``steps`` steps of ``batch`` x ``seq``
    Markov tokens (seed 0; frames for a frames model), with the launch
    counts reset just before and read just after."""
    import math

    from repro_torch.kernels import ops
    from repro_torch.launch import train as ptrain

    steps_n = warmup + steps
    times: list[float] = []
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # allocated at the reset: what earlier phases left
    base_bytes = torch.cuda.memory_allocated() if on_card else 0
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
    step_s = statistics.median(times[warmup:])
    return {"cfg": cfg, "state": state, "losses": vals, "times": times,
            "step_s": step_s, "tokens_per_s": batch * seq / step_s,
            "wall_s": wall, "counts": counts, "routes": routes,
            "bwd_routes": bwd_routes,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else None),
            "base_bytes": base_bytes,
            "params": sum(p.numel() for p in state["params"].parameters())}


def train_time_split(torch, run: dict) -> dict:
    """One more step of the trained state, taken apart with a synchronise
    between the parts: forward (embedding, units, tail, final norm), loss
    chunks, backward (with the units' and the chunks' recompute),
    optimizer; then the units' forward alone without grad, the size of the
    backward's recompute. The device busy share and the kernels that take
    the most device time come from ``torch.profiler`` (device activity
    only, :class:`primed_profile`) over the step."""
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
    with primed_profile(torch) as window:
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
                x, _, _ = tf.apply_block(unit[f"b{i}"], x, cfg, kind, pos)
        mark()
        del x
    fwd, loss_s, bwd, opt = (b - a for a, b in zip(marks[:4], marks[1:5],
                                                   strict=True))
    units = marks[6] - marks[5]
    events = window.events()
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

    build = ROOT / "build"
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


# --------------------------------------------------------------- phase 9
def decode_bound(model, cfg, batch: int, prompt: int, gen: int) -> dict:
    """The bytes one decode step must move, averaged over a run's ``gen``
    steps after a ``prompt``: every weight but the embedding table read
    once, each attention layer's bf16 keys and values at the positions the
    step attends to (all up to it, or its window's) read, and each
    recurrent layer's float32 state (its decode cache) read and written;
    over HBM_BW, the step's bound in ms."""
    from repro_torch.configs import ATTN_KINDS
    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention as attn

    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed")
    per_position = 2 * batch * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    positions, state = 0, 0
    for _, kind in model.blocks():
        if kind not in ATTN_KINDS:
            state += 2 * sum(t.numel() * t.element_size() for t in
                             tf._block_cache(cfg, kind, batch, 0,
                                             "meta").values())
            continue
        window = attn.window_for(kind, cfg)
        for t in range(gen):
            n = prompt + t + 1
            positions += n if window is None else min(n, window)
    cache = per_position * positions / gen
    return {"weight_bytes": weights, "cache_bytes": cache,
            "state_bytes": state,
            "bound_ms": (weights + cache + state) / HBM_BW * 1e3}


def busy_split(window: primed_profile, wall_s: float, per: int = 1) -> dict:
    """From a :class:`primed_profile` window of ``wall_s`` seconds: the
    device busy share, device ms per ``per`` calls, flash_attention's share
    of the device time and the six kernels taking the most; only the wall
    time when the profiler recorded nothing."""
    events = window.events()
    if not events:
        return {"wall_ms": wall_s * 1e3 / per, "device_ms": None,
                "not_measured": "no device record in the window"}
    busy = sum(e.self_device_time_total for e in events)
    flash = sum(e.self_device_time_total for e in events
                if "flash_attention" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_s * 1e3 / per, "device_ms": busy / 1e3 / per,
            "busy_share": busy / (wall_s * 1e6),
            "flash_share": flash / max(busy, 1e-30),
            "launches": sum(e.count for e in events) // per,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               / per for e in top}}


def serve_time_split(torch, run: dict, steps: int = SPLIT_DECODE_STEPS,
                     prefilled=None) -> dict:
    """One more kernel prefill of the run's inputs, then ``steps`` decode
    steps after it (the greedy tokens, or the run's next frames), each
    under ``torch.profiler`` between synchronises: see :func:`busy_split`.
    Given ``prefilled``, the (logits, cache) of a prefill of the run's
    inputs already run, the decode steps start from it alone."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as tf

    cfg, model = run["cfg"], run["model"]
    dev = model.device
    prompts = torch.from_numpy(run["prompts"]).to(dev)
    P = prompts.shape[1]
    decode = make_decode_step(cfg)
    frames = None
    if cfg.embed_mode == "frames":
        frames = torch.from_numpy(run["step_frames"][:steps]).to(dev)
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        if prefilled is not None:
            logits, cache = prefilled
        else:
            with primed_profile(torch) as window:
                t = time.perf_counter()
                logits, cache = tf.prefill(model, cfg, prompts,
                                           capacity=P + steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            out["prefill"] = busy_split(window, wall)
        with primed_profile(torch) as window:
            t = time.perf_counter()
            for i in range(steps):
                x = frames[i] if frames is not None else torch.argmax(
                    logits[:, -1], dim=-1).to(torch.int32)[:, None]
                logits, cache = decode(model, cache, x, P + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        out["decode"] = busy_split(window, wall, per=steps)
    return out


def serve_family(torch, arch: str, layers, requests: int) -> dict:
    """Phase 9 for one model: ``arch`` at full width (``layers`` of its
    layers, all when None) served on ``requests`` inputs of FAMILY_PROMPT
    positions and FAMILY_GEN decode steps (:func:`serve_model`); each
    layer's mixer kernel vs plain (:func:`check_layers_against_plain`); the
    whole prefill kernel vs plain within its FAMILY_PREFILL_RTOL, as the
    sound route with P rounded once to bf16 must be, with the causal mask
    off and (GQA or MHA) the kv heads rolled planted in every layer and
    the control (P kept to CONTROL_P_BITS bits) exceeding it; the time
    split; the decode step's bound. The model is freed before it
    returns."""
    import gc

    full_layers = family_config(arch, None).num_layers
    cfg = family_config(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    run = serve_model(torch, cfg, requests=requests, prompt=FAMILY_PROMPT,
                      gen=FAMILY_GEN)
    t = time.perf_counter()
    layer_check = check_layers_against_plain(torch, run)
    layer_s = time.perf_counter() - t
    t = time.perf_counter()
    # an unwindowed kind's faults: the causal mask off, the kv heads rolled
    agree = check_model_against_plain(
        torch, run, gen=FAMILY_GEN, rtol=FAMILY_PREFILL_RTOL[arch],
        faults=attention_faults(cfg, "attn"),
        sound={f"P to {SOUND_P_BITS} bits": rounded_p_attention(
            torch, SOUND_P_BITS)},
        controls={f"P to {CONTROL_P_BITS} bits": rounded_p_attention(
            torch, CONTROL_P_BITS)})
    model_s = time.perf_counter() - t
    split = serve_time_split(torch, run)
    bound = decode_bound(run["model"], cfg, requests, FAMILY_PROMPT,
                         FAMILY_GEN)
    tm = run["timings"]
    out = {"arch": arch, "layers": cfg.num_layers, "full_layers": full_layers,
           "attn_layers": sum(run["shapes"].values()),
           "params": run["params"], "init_s": run["init_s"],
           "requests": requests, "prefill_s": tm["prefill_s"],
           "decode_ms": tm["decode_s"] * 1e3 / FAMILY_GEN,
           "decode_tokens_per_s": requests * FAMILY_GEN / tm["decode_s"],
           "decode_bound": bound, "generate_peak_gib": run["peak_gib"],
           "counts": {k: v for k, v in run["counts"].items() if v},
           "routes": run["routes"], "shapes": run["shapes"],
           "out_head": run["out"][0, :8].tolist(),
           "layers_worst": layer_check["worst"]["out"],
           "layers_per_layer": [e["out"] for e in layer_check["per_layer"]],
           "layers_planted": {n: e["out"] for n, e in
                              layer_check["planted"].items()},
           "layer_check_s": layer_s, "prefill_check": agree,
           "prefill_check_s": model_s, "split": split}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def log_family(fam: dict, wall_s: float) -> None:
    phase = "14d" if fam["arch"] == DEFAULT_ARCH else "9"
    agree, split, bound = (fam["prefill_check"], fam["split"],
                           fam["decode_bound"])
    cut = ("" if fam["layers"] == fam["full_layers"] else
           f" (reduced: num_layers {fam['full_layers']} -> {fam['layers']})")
    log(f"phase {phase} {fam['arch']}: {fam['layers']} layers{cut}, "
        f"{fam['params']} parameters built in {fam['init_s']:.3f} s; "
        f"{fam['requests']} x {FAMILY_PROMPT} prompt + {FAMILY_GEN} decode "
        f"steps: prefill {fam['prefill_s']:.3f} s, decode "
        f"{fam['decode_ms']:.3f} ms per step ({fam['decode_tokens_per_s']:.1f}"
        f" tokens/s) against a bound of {bound['bound_ms']:.3f} ms "
        f"({bound['weight_bytes']} weight bytes + {bound['cache_bytes']:.0f} "
        f"cache bytes a step at 3.35 TB/s); peak device memory "
        f"{fam['generate_peak_gib']:.3f} GiB in generate, "
        f"{fam['peak_gib']:.3f} GiB in the phase; launches {fam['counts']}, "
        f"flash_attention routes {fam['routes']}, by (B, Hq, Hkv, S, hd, "
        f"window) {fam['shapes']}; first codes {fam['out_head']}")
    log(f"phase {phase} {fam['arch']}: decode_attention launches "
        f"{fam['counts'].get('decode_attention', 0)} = {fam['attn_layers']} "
        f"attention layers x {decode_issues(fam['counts'], FAMILY_GEN)} "
        f"host issues of {FAMILY_GEN} decode steps (graph captures "
        f"{fam['counts'].get('decode_graph.captures', 0)}, replays "
        f"{fam['counts'].get('decode_graph.replays', 0)})")
    log(f"phase {phase} {fam['arch']} layer by layer, kernel vs plain mixer: "
        f"worst {fam['layers_worst']:.3e} (limit {MIXER_RTOL}); planted "
        f"{json.dumps(fam['layers_planted'])}; per layer " + " ".join(
            f"{x:.2e}" for x in fam["layers_per_layer"])
        + f"; {fam['layer_check_s']:.3f} s")
    log(f"phase {phase} {fam['arch']} prefill kernel "
        f"{agree['kernel_prefill_s']:.3f} s vs plain "
        f"{agree['plain_prefill_s']:.3f} s: logits max rel err "
        f"{agree['logits_rel_err']:.3e}, worst {agree['worst']} "
        f"{agree['worst_rel_err']:.3e} (limit {agree['limit']:.4e}); planted "
        f"{json.dumps(agree['planted'])}; sound and control routes "
        f"{json.dumps(agree['stand_in'])}; per-layer cache " + " ".join(
            f"{x:.2e}" for x in agree["per_layer"])
        + f"; {fam['prefill_check_s']:.3f} s")
    log(f"phase {phase} {fam['arch']} time split: {json.dumps(split)}; model "
        f"{wall_s:.3f} s")


def train_family(torch) -> dict:
    """Phase 9's training: one FAMILY_TRAIN_ARCH layer's gradients kernel
    vs plain route (:func:`check_training_gradients` on a frames batch),
    then ``launch.train.run`` on the full model (FAMILY_TRAIN_WARMUP +
    FAMILY_TRAIN_STEPS steps of 2 x 4096 frames). Returns that run's
    launch counts."""
    import gc

    from repro_torch.configs import get_config

    cfg = get_config(FAMILY_TRAIN_ARCH)
    t = time.perf_counter()
    grads = check_training_gradients(torch, cfg)
    torch.cuda.empty_cache()
    log(f"phase 9 {cfg.name} one layer at full width, frames batch, kernel "
        f"vs plain route: loss {grads['loss_kernel']:.6f} vs "
        f"{grads['loss_plain']:.6f}; worst gradient {grads['worst']} "
        f"{grads['worst_rel_err']:.3e} (limit {GRAD_RTOL}); planted "
        f"{json.dumps(grads['planted'])}; {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    run = train_model(torch, cfg, warmup=FAMILY_TRAIN_WARMUP,
                      steps=FAMILY_TRAIN_STEPS)
    launches = run["counts"]
    counts = {k: v for k, v in launches.items() if v}
    log(f"phase 9 train {cfg.name}: {run['params']} parameters, "
        f"{FAMILY_TRAIN_WARMUP} + {FAMILY_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} frames: losses "
        + " ".join(f"{x:.4f}" for x in run["losses"])
        + "; step s " + " ".join(f"{x:.3f}" for x in run["times"])
        + f"; median timed step {run['step_s']:.3f} s, "
        f"{run['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{run['peak_gib']:.3f} GiB; launches {counts} (per step "
        f"{launches_per_step(cfg)}), flash_attention routes {run['routes']}"
        f", flash_attention_bwd routes {run['bwd_routes']}; "
        f"{time.perf_counter() - t:.3f} s")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_config(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def family_attention_shapes(cfg, requests: int,
                            prompt: int = FAMILY_PROMPT) -> dict:
    """{(B, Hq, Hkv, S, hd, window): layers}: the attention calls a
    prefill of ``requests`` x ``prompt`` positions makes, one per
    attention layer; a window is passed only where the prompt is longer
    than it and a multiple of it (``nn.attention.attn_forward``)."""
    from repro_torch.configs import ATTN_KINDS
    from repro_torch.nn import attention as attn

    S, calls = prompt, {}
    for kind in list(cfg.pattern) * cfg.num_units + list(cfg.tail_pattern):
        if kind not in ATTN_KINDS:
            continue
        window = attn.window_for(kind, cfg)
        if window is not None and (window >= S or S % window):
            window = None
        key = (requests, cfg.n_heads, cfg.n_kv_heads, S,
               cfg.resolved_head_dim, window)
        calls[key] = calls.get(key, 0) + 1
    return calls


def serve_families(torch, rows: list, runs=PHASE9_RUNS,
                   train: bool = True) -> None:
    """Phase 9 (and 14d, on the default model's entry of FAMILY_RUNS).
    First a ``flash_attention`` row at every attention shape ``runs`` will
    launch and, with ``train``, a ``flash_attention_bwd`` row at
    FAMILY_TRAIN_ARCH's training shape, on a card that holds no model
    yet; then each model through :func:`serve_family`, whose tally of attention
    calls must equal :func:`family_attention_shapes` (which proves that
    gemma3's local layers got their window) and whose ``flash_attention``
    launch count must equal its total, and with ``train``
    :func:`train_family`. The rows,
    with the launches of those runs split by shape as
    :func:`family_attention_shapes` gives them (summed over the models
    that share a shape), are appended to ``rows``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 9)
    expected = {arch: family_attention_shapes(family_config(arch, layers),
                                              requests)
                for arch, layers, requests in runs}
    by_shape: dict = {}
    for arch, calls in expected.items():
        for key in calls:
            if key not in by_shape:
                B, Hq, Hkv, S, hd, window = key
                by_shape[key] = flash_attention_case(
                    torch, g, (B, Hq, Hkv, S, hd), torch.bfloat16, window,
                    1e-2)
                by_shape[key].update(launches=0, models=[])
            by_shape[key]["models"].append(arch)
    if train:
        bwd_row = flash_attention_bwd_case(
            torch, g, FLASH_FAMILY_TRAIN_SHAPE, torch.bfloat16, None,
            BWD_RTOL_BF16)
    for arch, layers, requests in runs:
        t = time.perf_counter()
        fam = serve_family(torch, arch, layers, requests)
        check(fam["shapes"] == expected[arch],
              f"{arch}: attention calls {fam['shapes']}, expected "
              f"{expected[arch]}")
        check(fam["counts"].get("flash_attention") == sum(
            expected[arch].values()), f"{arch}: flash_attention launched "
              f"{fam['counts']}, expected {sum(expected[arch].values())}")
        # the wrapper's count is the run's launches; the checks above split
        # it by shape as the model's layers do
        for key, n in expected[arch].items():
            by_shape[key]["launches"] += n
        log_family(fam, time.perf_counter() - t)
    rows.extend(by_shape.values())
    if train:
        bwd_row["launches"] = train_family(torch)["flash_attention_bwd"]
        rows.append(bwd_row)


# --------------------------------------------------------------- phase 10
MOE_ROUTING_FAULTS = ("top_w not renormalised", "the (k+1)-th expert chosen",
                      "sel_w left out", "router in bf16")


class routing_tap:
    """Within ``with``, every call of ``nn.moe._routing`` records the top-k
    expert set it chose for each token in ``sets`` ((T, k) uint8, sorted
    ids) and every call of ``nn.moe.dispatch`` (the dropping path) the
    tokens it chose in ``slots`` ((G, E, C) sel_idx, each expert's sorted),
    in call order (a prefill's MoE layers in layer order).

    With ``replay``, the tap of another route's run of the same prefill,
    each call goes on with the replay's choice in place of its own: the
    replay's expert sets, weighted by this route's own probabilities
    (renormalised), and the replay's slots, weighted by this route's
    ``combine``. A bf16 step that moves a token across the top-k boundary
    (or an expert's capacity) then changes only its weights, as it does
    every other token's, and does not spread through the layers after;
    ``sets`` and ``slots`` still hold the route's own choices, so its flips
    are counted all the same.

    ``fault``, one of MOE_ROUTING_FAULTS, is planted in the choice (in the
    route's own, and in the replayed one): the top-k probabilities not
    renormalised; each token's chosen expert of least probability swapped
    for the most probable one outside its set (from its own top-k: the
    (k+1)-th expert); the dropping path's selected tokens all weighing 1
    (the zero-weight fillers' too); the logits taken from x and the router
    rounded to bf16 (what ``weight_dtype`` would make of the router on a
    card)."""

    def __init__(self, torch, replay=None, fault=None):
        check(fault is None or fault in MOE_ROUTING_FAULTS, f"fault {fault}")
        self.torch, self.replay, self.fault = torch, replay, fault
        self.sets, self.slots = [], []

    def __enter__(self):
        from repro_torch.nn import moe

        self.moe, self.real = moe, (moe._routing, moe.dispatch)
        moe._routing, moe.dispatch = self.routing, self.dispatch
        return self

    def __exit__(self, *exc):
        self.moe._routing, self.moe.dispatch = self.real

    def routing(self, p, x, cfg):
        import torch.nn.functional as F

        torch = self.torch
        if self.replay is None and self.fault is None:
            out = self.real[0](p, x, cfg)
            self.sets.append(out[1].sort(dim=-1).values.byte())
            return out
        # nn.moe._routing, with the replay's sets and the fault
        if self.fault == "router in bf16":
            logits = (x.bfloat16() @ p.router.bfloat16()).float()
        else:
            logits = x.float() @ p.router
        probs = torch.softmax(logits, dim=-1)
        idx = self.planted(probs, self.moe._top_k(probs, cfg.top_k)[1])
        self.sets.append(idx.sort(dim=-1).values.byte())
        if self.replay is not None:
            idx = self.planted(probs, self.replay.sets[len(self.sets) - 1]
                               .long())
        top_w = probs.gather(1, idx)
        if self.fault != "top_w not renormalised":
            top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True),
                                        min=1e-9)
        onehot = F.one_hot(idx, cfg.n_experts).float()
        combine = (onehot * top_w[..., None]).sum(dim=1)
        aux = cfg.n_experts * torch.sum(onehot.sum(dim=1).mean(dim=0)
                                        * probs.mean(dim=0))
        return combine, idx, top_w, aux

    def planted(self, probs, idx):
        if self.fault != "the (k+1)-th expert chosen":
            return idx
        least = probs.gather(1, idx).argmin(dim=-1, keepdim=True)
        best_outside = probs.scatter(1, idx, -1.0).argmax(dim=-1,
                                                          keepdim=True)
        return idx.scatter(1, least, best_outside)

    def dispatch(self, combine, cfg):
        sel_w, sel_idx = self.real[1](combine, cfg)
        self.slots.append(sel_idx.sort(dim=-1).values)
        if self.replay is not None:
            sel_idx = self.replay.slots[len(self.slots) - 1]
            G, E, _ = sel_idx.shape
            sel_w = combine.reshape(G, -1, E).transpose(1, 2).gather(
                2, sel_idx)
        if self.fault == "sel_w left out":
            sel_w = self.torch.ones_like(sel_w)
        return sel_w, sel_idx


def flip_share(a: list, b: list) -> float:
    """The share of (token, layer) pairs whose top-k expert sets (or of
    (expert, slot) pairs whose tokens) differ between two taps of the same
    prefill."""
    check(len(a) == len(b), f"{len(a)} routing calls against {len(b)}")
    differ = sum(int((x != y).any(dim=-1).sum()) if x.dim() == 2
                 else int((x != y).sum()) for x, y in zip(a, b, strict=True))
    return differ / max(sum(x.shape[0] if x.dim() == 2 else x.numel()
                            for x in a), 1)


def moe_prefill_variants(torch, cfg, bits=(SOUND_P_BITS, CONTROL_P_BITS)
                         ) -> dict:
    """{name: (group, context factory, routing fault)} for
    :func:`moe_prefill_readings`: the faults that must exceed the limit (on
    the dense dispatch each attention layer with the causal mask off or,
    GQA, its kv heads rolled, and the routing with its top_w not
    renormalised or its (k+1)-th expert chosen; on the dropping dispatch
    ``sel_w`` left out), the finding reported only (the router in bf16,
    whose flips the replay takes out: :func:`check_routing_layers` holds
    it), and ``attention`` with P kept to each of ``bits`` significant bits
    (:func:`rounded_p_attention`): SOUND_P_BITS the sound route that must be
    within the limit, CONTROL_P_BITS the control that must exceed it,
    others (a probe's) reported."""
    import contextlib

    from repro_torch.kernels import ops

    none = contextlib.nullcontext
    if cfg.moe_impl == "dropping":
        out = {"sel_w left out": ("fault", none, "sel_w left out")}
    else:
        out = {name: ("fault", lambda a=alter: planted("flash_attention", a),
                      None)
               for name, alter in attention_faults(cfg, "attn").items()}
        out.update({name: ("fault", none, name) for name in (
            "top_w not renormalised", "the (k+1)-th expert chosen")})
        out["router in bf16"] = ("finding", none, "router in bf16")
    for b in bits:
        group = {SOUND_P_BITS: "sound", CONTROL_P_BITS: "control"}.get(
            b, "reading")
        out[f"P to {b} bits"] = (group, lambda b=b: swapped(
            ops, "flash_attention", rounded_p_attention(torch, b)), None)
    return out


def moe_prefill_readings(torch, run: dict, cfg, variants: dict) -> dict:
    """The prefill of the run's prompts under ``cfg`` (its ``moe_impl``),
    with room for MOE_GEN more positions, on the card in bf16,
    through the plain versions with their routing recorded
    (:class:`routing_tap`), then through the kernels as the model path runs
    them (``free``) and with the plain route's routing replayed
    (``kernel``), then each of ``variants`` ({name: (group, context
    factory, routing fault)}) with the replay, within its context and with
    its fault planted. Each reading: the worst tensor's largest-element
    error (:func:`max_rel_err` of the last-position logits and every
    layer's keys and values, against the plain prefill), the logits', and
    the share of (token, layer) pairs whose own top-k set differs from the
    plain route's (:func:`flip_share`; on the dropping path also of
    (expert, slot) pairs whose token differs)."""
    import contextlib

    from repro_torch.models import transformer as tf

    model = run["model"]
    device = model.device.type
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    capacity = prompts.shape[1] + MOE_GEN

    def prefill(tap, use_kernel=None):
        with torch.inference_mode(), tap:
            t = time.perf_counter()
            out = tf.prefill(model, cfg, prompts, capacity, use_kernel)
            sync(torch, device)
        return out, time.perf_counter() - t

    plain_tap = routing_tap(torch)
    plain, plain_s = prefill(plain_tap, False)

    def reading(out, tap, per_layer=False):
        errs = prefill_errors(torch, cfg, out, plain)
        worst = max(errs, key=errs.get)
        r = {"worst": worst, "err": errs[worst], "logits": errs["logits"],
             "flips": flip_share(tap.sets, plain_tap.sets)}
        if plain_tap.slots:
            r["slot_flips"] = flip_share(tap.slots, plain_tap.slots)
        if per_layer:
            r["per_layer"] = [max(v for k, v in errs.items()
                                  if k.startswith(f"layer{i}."))
                              for i in range(cfg.num_layers)]
        return r

    tap = routing_tap(torch)
    free, kernel_s = prefill(tap)
    check(tuple(free[0].shape) == (prompts.shape[0], 1, cfg.vocab_size),
          f"logits shape {tuple(free[0].shape)}")
    out = {"impl": cfg.moe_impl, "prompt": prompts.shape[1],
           "kernel_prefill_s": kernel_s, "plain_prefill_s": plain_s,
           "free": reading(free, tap)}
    del free
    readings = {}
    for name, (group, context, fault) in {
            "kernel": ("kernel", contextlib.nullcontext, None),
            **variants}.items():
        tap = routing_tap(torch, plain_tap, fault)
        with context():
            other, _ = prefill(tap)
        readings[name] = {"group": group,
                          **reading(other, tap, name == "kernel")}
        del other
    out["variants"] = readings
    return out


def check_moe_prefill(torch, run: dict, cfg, variants: dict) -> dict:
    """:func:`moe_prefill_readings`, held to MOE_PREFILL_RTOL: the kernel
    route and the sound route within it, every fault and the control over
    it; a finding and the free-running kernel route are reported."""
    r = moe_prefill_readings(torch, run, cfg, variants)
    name = f"{cfg.name} {cfg.moe_impl} prefill vs plain, routing replayed"
    over = {n: v["err"] for n, v in r["variants"].items()
            if v["group"] in ("kernel", "sound")
            and v["err"] > MOE_PREFILL_RTOL}
    check(not over, f"{name}: over the limit {MOE_PREFILL_RTOL}: {over} "
                    f"{r['variants']}")
    missed = {n: v["err"] for n, v in r["variants"].items()
              if v["group"] in ("fault", "control")
              and v["err"] <= MOE_PREFILL_RTOL}
    check(not missed, f"{name}: faults not caught by the limit "
                      f"{MOE_PREFILL_RTOL}: {missed} {r['variants']}")
    return r


def routing_layer_flips(torch, run: dict) -> dict:
    """Routing compared layer by layer, each MoE layer fed the plain
    route's hidden state, so that no flip carries over from the layers
    before: per layer, the share of tokens whose top-k expert set differs
    from the plain route's when the layer's attention runs through the
    kernel, through the sound route (P rounded once to bf16,
    :func:`rounded_p_attention`), and, on the plain route's input, with the
    router in bf16 (:class:`routing_tap`'s fault); and each one's share
    over the prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention as attn
    from repro_torch.nn import moe
    from repro_torch.nn.layers import apply_norm

    cfg, model = run["cfg"], run["model"]
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    B, S = prompts.shape
    positions = torch.arange(S, dtype=torch.int32, device=model.device)[
        None].expand(B, S)
    sound = rounded_p_attention(torch, SOUND_P_BITS)
    names = ("kernel", f"P to {SOUND_P_BITS} bits", "router in bf16")
    per_layer: dict = {n: [] for n in names}
    with torch.inference_mode():
        x = tf.embed_inputs(model, cfg, prompts, positions)
        for block, kind in model.blocks():
            def ffn_input(use_kernel):
                a = attn.attn_forward(block.mixer, apply_norm(
                    block.norm1, x, cfg.norm), cfg, kind, positions,
                    use_kernel=use_kernel)
                return apply_norm(block.norm2, tf._mixer_residual(
                    block, x, a, cfg), cfg.norm).reshape(B * S, -1)

            def chosen(h, fault=None):
                with routing_tap(torch, fault=fault) as tap:
                    moe._routing(block.ffn, h, cfg)
                return tap.sets

            h = ffn_input(False)
            plain = chosen(h)
            per_layer["router in bf16"].append(flip_share(
                chosen(h, "router in bf16"), plain))
            per_layer["kernel"].append(flip_share(
                chosen(ffn_input(None)), plain))
            with swapped(ops, "flash_attention", sound):
                per_layer[names[1]].append(flip_share(
                    chosen(ffn_input(None)), plain))
            x, _, _ = tf.apply_block(block, x, cfg, kind, positions, False)
            del h
    return {"share": {n: sum(v) / len(v) for n, v in per_layer.items()},
            "per_layer": per_layer}


def check_routing_layers(torch, run: dict) -> dict:
    """:func:`routing_layer_flips`: over the prefill the bf16 router must
    flip more than BF16_ROUTER_FLIPS times the share of either sound route
    (the kernel's, P rounded once): the fault the float32 router guards
    against, which the replayed prefill (:func:`check_moe_prefill`) cannot
    see."""
    r = routing_layer_flips(torch, run)
    share = r["share"]
    sound = max(v for n, v in share.items() if n != "router in bf16")
    check(share["router in bf16"] > BF16_ROUTER_FLIPS * sound,
          f"routing layer by layer: the bf16 router flips {share} of "
          f"tokens, not over {BF16_ROUTER_FLIPS} x the sound routes'")
    return r


def check_moe_layer(torch, run: dict) -> dict:
    """One MoE layer at full width (the first), on its input in the run's
    prefill (the plain route's hidden state after the first block's mixer,
    through norm2): every router float32 and every expert weight in the
    compute dtype in the serving model; dropping at capacity_factor
    MOE_HIGH_CAPACITY (C = T, nothing dropped) against dense, and with
    MOE_GROUPS groups against one, within MIXER_RTOL (the reference's two
    checks); two calls of the dropping dispatch at MOE_CAPACITY bit-equal
    (index_add's atomics sum at most top_k nonzero terms a row); the share
    of routed (token, expert) pairs it drops. On a card the dense and
    dropping layers are timed too (:func:`time_moe_layer`)."""
    import dataclasses

    from repro_torch.models import transformer as tf
    from repro_torch.nn import attention as attn
    from repro_torch.nn import moe
    from repro_torch.nn.layers import apply_norm, compute_dtype

    cfg, model = run["cfg"], run["model"]
    cdt = compute_dtype(model.device)
    wrong = [n for n, p in model.named_parameters() if ".ffn." in n
             and p.dtype != (torch.float32 if n.endswith("router") else cdt)]
    check(not wrong, f"MoE parameters of the wrong dtype: {wrong[:4]}")
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    B, S = prompts.shape
    positions = torch.arange(S, dtype=torch.int32, device=model.device)[
        None].expand(B, S)
    dense = dataclasses.replace(cfg, moe_impl="dense")
    drop = dataclasses.replace(cfg, moe_impl="dropping", moe_groups=0,
                               capacity_factor=MOE_CAPACITY)
    high = dataclasses.replace(drop, capacity_factor=MOE_HIGH_CAPACITY)
    grouped = dataclasses.replace(high, moe_groups=MOE_GROUPS)
    with torch.inference_mode():
        block, kind = next(model.blocks())
        x = tf.embed_inputs(model, cfg, prompts, positions)
        a = attn.attn_forward(block.mixer, apply_norm(block.norm1, x,
                                                      cfg.norm),
                              cfg, kind, positions, use_kernel=False)
        h = apply_norm(block.norm2, tf._mixer_residual(block, x, a, cfg),
                       cfg.norm)
        del x, a
        p = block.ffn
        y_dense, aux = moe.moe_dense(p, h, dense)
        y_high, _ = moe.moe_dropping(p, h, high)
        y_grouped, _ = moe.moe_dropping(p, h, grouped)
        errs = {"dropping at capacity 8 vs dense": max_rel_err(
                    torch, y_high, y_dense),
                f"{MOE_GROUPS} groups vs one at capacity 8": max_rel_err(
                    torch, y_grouped, y_high)}
        del y_dense, y_high, y_grouped
        first, _ = moe.moe_dropping(p, h, drop)
        second, _ = moe.moe_dropping(p, h, drop)
        bit_equal = bool(torch.equal(first, second))
        del first, second
        sel_w, _ = moe.dispatch(moe._routing(p, h.reshape(B * S, -1),
                                             drop)[0], drop)
        slots = sel_w.numel()
        dropped = 1 - int((sel_w > 0).sum()) / (B * S * cfg.top_k)
        del sel_w
        timed = (time_moe_layer(torch, p, h, {"dense": (dense, B * S * cfg
                                                        .n_experts),
                                              "dropping": (drop, slots)})
                 if model.device.type == "cuda" else None)
    check(bit_equal, "moe_dropping: two identical calls differ")
    over = {n: e for n, e in errs.items() if e > MIXER_RTOL}
    check(not over, f"MoE layer checks over {MIXER_RTOL}: {over}")
    return {"errs": errs, "bit_equal": bit_equal, "aux": float(aux),
            "dropped_share": dropped, "timed": timed}


def time_moe_layer(torch, p, h, impls: dict) -> dict:
    """Each of ``impls`` ({name: (cfg, slots)}) on MoE layer ``p`` and
    input ``h``, timed on the card: CUDA events (:func:`cuda_ms`) and the
    device time of 3 calls in a :class:`primed_profile` window
    (:func:`busy_split`), beside its bound: 2 x 3 x D x F operations per
    (token, expert) slot on the bf16 tensor cores, or the expert weights
    and the tokens in and out read once."""
    from repro_torch.nn import moe

    E, D, F = p.w1.shape
    T = h.shape[0] * h.shape[1]
    out = {}
    for name, (cfg, slots) in impls.items():
        def call(cfg=cfg):
            return moe.moe_forward(p, h, cfg)
        ms = cuda_ms(torch, call, reps=5, warmup=1)
        with primed_profile(torch) as window:
            t = time.perf_counter()
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        b_ms, b_by = bound(2 * (3 * E * D * F + 2 * T * D),
                           2 * 3 * D * F * slots, BF16_TC_FLOPS)
        out[name] = {"ms": ms, "device_ms": busy_split(window, wall, per=3)[
            "device_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "slots": slots}
    return out


def serve_moe(torch, arch: str, layers: int, requests: int,
              prompt: int) -> dict:
    """Phase 10 for one model: ``arch`` at full width, ``layers`` deep, on
    the dense dispatch, served on ``requests`` prompts of ``prompt`` tokens
    and MOE_GEN greedy steps (:func:`serve_model`); each layer's mixer
    kernel vs plain (:func:`check_layers_against_plain`, with the window's
    faults on a windowed model); :func:`check_moe_layer`; the routing layer
    by layer (:func:`check_routing_layers`); the whole prefill kernel vs
    plain with the plain route's routing replayed (:func:`check_moe_prefill`)
    with :func:`moe_prefill_variants`; on MOE_DROPPING_ARCH the same on the
    dropping dispatch at MOE_CAPACITY, and a prefill of MOE_GROUPS_PROMPT
    tokens on MOE_GROUPS groups; the time split; the decode step's bound.
    The model is freed before it returns."""
    import dataclasses
    import gc

    from repro_torch.models import transformer as tf

    full_layers = family_config(arch, None).num_layers
    cfg = family_config(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    run = serve_model(torch, cfg, requests=requests, prompt=prompt,
                      gen=MOE_GEN)
    t = time.perf_counter()
    layer_check = check_layers_against_plain(torch, run)
    moe_layer = check_moe_layer(torch, run)
    routing = check_routing_layers(torch, run)
    layer_s = time.perf_counter() - t
    t = time.perf_counter()
    prefills = [check_moe_prefill(torch, run, cfg,
                                  moe_prefill_variants(torch, cfg))]
    grouped = None
    if arch == MOE_DROPPING_ARCH:
        drop = dataclasses.replace(cfg, moe_impl="dropping",
                                   capacity_factor=MOE_CAPACITY)
        prefills.append(check_moe_prefill(torch, run, drop,
                                          moe_prefill_variants(torch, drop)))
        few = torch.from_numpy(run["prompts"][:, :MOE_GROUPS_PROMPT]).to(
            run["model"].device)
        with torch.inference_mode():
            s = time.perf_counter()
            logits, _ = tf.prefill(run["model"], dataclasses.replace(
                drop, moe_groups=MOE_GROUPS), few)
            torch.cuda.synchronize()
            grouped = {"prompt": few.shape[1], "groups": MOE_GROUPS,
                       "prefill_s": time.perf_counter() - s}
        check(tuple(logits.shape) == (requests, 1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"grouped dropping prefill logits {tuple(logits.shape)}")
        del logits, few
    prefill_s = time.perf_counter() - t
    split = serve_time_split(torch, run)
    bound = decode_bound(run["model"], cfg, requests, prompt, MOE_GEN)
    tm = run["timings"]
    out = {"arch": arch, "layers": cfg.num_layers, "full_layers": full_layers,
           "params": run["params"], "init_s": run["init_s"],
           "requests": requests, "prompt": prompt,
           "prefill_s": tm["prefill_s"],
           "decode_ms": tm["decode_s"] * 1e3 / MOE_GEN,
           "decode_tokens_per_s": requests * MOE_GEN / tm["decode_s"],
           "decode_bound": bound, "generate_peak_gib": run["peak_gib"],
           "counts": {k: v for k, v in run["counts"].items() if v},
           "routes": run["routes"], "shapes": run["shapes"],
           "out_head": run["out"][0, :8].tolist(),
           "layers_worst": layer_check["worst"]["out"],
           "layers_planted": {n: e["out"] for n, e in
                              layer_check["planted"].items()},
           "moe_layer": moe_layer, "routing": routing,
           "layer_check_s": layer_s,
           "prefills": prefills, "grouped": grouped,
           "prefill_check_s": prefill_s, "split": split}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def log_moe(m: dict, wall_s: float) -> None:
    bound, layer = m["decode_bound"], m["moe_layer"]
    log(f"phase 10 {m['arch']}: {m['layers']} layers (reduced: num_layers "
        f"{m['full_layers']} -> {m['layers']}), {m['params']} parameters "
        f"built in {m['init_s']:.3f} s; {m['requests']} x {m['prompt']} "
        f"prompt + {MOE_GEN} decode steps: prefill {m['prefill_s']:.3f} s, "
        f"decode {m['decode_ms']:.3f} ms per step "
        f"({m['decode_tokens_per_s']:.1f} tokens/s) against a bound of "
        f"{bound['bound_ms']:.3f} ms ({bound['weight_bytes']} weight bytes "
        f"+ {bound['cache_bytes']:.0f} cache bytes a step at 3.35 TB/s); "
        f"peak device memory {m['generate_peak_gib']:.3f} GiB in generate, "
        f"{m['peak_gib']:.3f} GiB in the phase; launches {m['counts']}, "
        f"flash_attention routes {m['routes']}, by (B, Hq, Hkv, S, hd, "
        f"window) {m['shapes']}; first tokens {m['out_head']}")
    log(f"phase 10 {m['arch']} layer by layer, kernel vs plain mixer: worst "
        f"{m['layers_worst']:.3e} (limit {MIXER_RTOL}); planted "
        f"{json.dumps(m['layers_planted'])}; MoE layer 0: "
        f"{json.dumps(layer)}; routing layer by layer on the plain route's "
        f"input, flip share {json.dumps(m['routing']['share'])} (the bf16 "
        f"router over {BF16_ROUTER_FLIPS} x the sound routes'), per layer "
        f"{json.dumps(m['routing']['per_layer'])}; "
        f"{m['layer_check_s']:.3f} s")
    for agree in m["prefills"]:
        kernel = agree["variants"]["kernel"]
        log(f"phase 10 {m['arch']} {agree['impl']} prefill kernel "
            f"{agree['kernel_prefill_s']:.3f} s vs plain "
            f"{agree['plain_prefill_s']:.3f} s; as it runs: "
            f"{json.dumps(agree['free'])}; with the plain route's routing "
            f"replayed: worst {kernel['worst']} {kernel['err']:.3e} (limit "
            f"{MOE_PREFILL_RTOL}), logits {kernel['logits']:.3e}, own flip "
            f"share {kernel['flips']:.3e}, per-layer cache max rel err "
            + " ".join(f"{x:.2e}" for x in kernel["per_layer"])
            + "; variants " + json.dumps(
                {n: v for n, v in agree["variants"].items() if n != "kernel"}))
    log(f"phase 10 {m['arch']} grouped dropping prefill "
        f"{json.dumps(m['grouped'])}; checks {m['prefill_check_s']:.3f} s; "
        "time split "
        f"{json.dumps(m['split'])}; model {wall_s:.3f} s")


def check_aux_gradients(torch, cfg, model, batch) -> dict:
    """The training loss of ``model`` on ``batch`` holds a nonzero MoE aux
    (the loss is the cross entropy plus AUX_LOSS_WEIGHT times it), whose
    gradient reaches every layer's router, finite and nonzero."""
    import math

    from repro_torch.launch import steps

    loss, metrics = steps.loss_fn(model, cfg, batch)
    routers = [b.ffn.router for b, _ in model.blocks()]
    grads = torch.autograd.grad(metrics["aux"], routers)
    aux, ce = float(metrics["aux"].detach()), float(metrics["ce"].detach())
    total = float(loss.detach())
    norms = [float(g.abs().max()) for g in grads]
    check(aux > 0 and math.isclose(total, ce + steps.AUX_LOSS_WEIGHT * aux,
                                   rel_tol=1e-5),
          f"loss {total}, ce {ce}, aux {aux}")
    check(len(norms) == cfg.num_layers
          and all(math.isfinite(n) and n > 0 for n in norms),
          f"aux gradient into the routers: largest |d aux / d router| "
          f"{norms}")
    return {"loss": total, "ce": ce, "aux": aux, "router_grad_max": norms}


def train_moe(torch) -> dict:
    """Phase 10's training: ``launch.train.run`` on MOE_TRAIN_ARCH at full
    width, MOE_TRAIN_LAYERS deep, MOE_TRAIN_WARMUP + MOE_TRAIN_STEPS steps
    of TRAIN_BATCH x MOE_TRAIN_SEQ Markov tokens (:func:`train_model`);
    then :func:`check_aux_gradients` on the next batch. Returns the run's
    launch counts."""
    import gc

    from repro_torch.launch import steps

    cfg = family_config(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS)
    t = time.perf_counter()
    run = train_model(torch, cfg, seq=MOE_TRAIN_SEQ, warmup=MOE_TRAIN_WARMUP,
                      steps=MOE_TRAIN_STEPS)
    aux = check_aux_gradients(torch, cfg, run["state"]["params"],
                              training_batch(
                                  cfg, MOE_TRAIN_WARMUP + MOE_TRAIN_STEPS,
                                  TRAIN_BATCH, MOE_TRAIN_SEQ))
    launches = run["counts"]
    full = family_config(MOE_TRAIN_ARCH, None).num_layers
    log(f"phase 10 train {cfg.name}: {run['params']} parameters "
        f"({MOE_TRAIN_LAYERS} of {full} layers), {MOE_TRAIN_WARMUP} + "
        f"{MOE_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens: losses "
        + " ".join(f"{x:.4f}" for x in run["losses"])
        + "; step s " + " ".join(f"{x:.3f}" for x in run["times"])
        + f"; median timed step {run['step_s']:.3f} s, "
        f"{run['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{run['peak_gib']:.3f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} } (per step "
        f"{launches_per_step(cfg)}), flash_attention routes {run['routes']}"
        f", flash_attention_bwd routes {run['bwd_routes']}; next batch: "
        f"loss {aux['loss']:.4f} = ce {aux['ce']:.4f} + "
        f"{steps.AUX_LOSS_WEIGHT} x aux {aux['aux']:.4f}, largest |d aux / "
        "d router| per layer "
        + " ".join(f"{n:.3e}" for n in aux["router_grad_max"])
        + f"; {time.perf_counter() - t:.3f} s")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_moe_family(torch, rows: list) -> None:
    """Phase 10. First a ``flash_attention`` row at every attention shape
    the MOE_RUNS will launch and at MOE_TRAIN_ARCH's training shape, and a
    ``flash_attention_bwd`` row there, on a card that holds no model yet;
    then each model through :func:`serve_moe`, whose tally of attention
    calls must equal :func:`family_attention_shapes` (mixtral's every
    layer with its window of 4096) and whose ``flash_attention`` launch
    count must equal its total, and :func:`train_moe`. The rows, with the
    launches of those runs, are appended to ``rows``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 10)
    expected = {arch: family_attention_shapes(family_config(arch, layers),
                                              requests, prompt)
                for arch, layers, requests, prompt in MOE_RUNS}
    by_shape: dict = {}
    for arch, calls in expected.items():
        for key in calls:
            B, Hq, Hkv, S, hd, window = key
            by_shape[key] = flash_attention_case(
                torch, g, (B, Hq, Hkv, S, hd), torch.bfloat16, window, 1e-2)
            by_shape[key].update(launches=0, models=[arch])
    cfg = family_config(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS)
    shape = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, MOE_TRAIN_SEQ,
             cfg.resolved_head_dim)
    train_row = flash_attention_case(torch, g, shape, torch.bfloat16, None,
                                     1e-2)
    bwd_row = flash_attention_bwd_case(torch, g, shape, torch.bfloat16,
                                       None, BWD_RTOL_BF16)
    for arch, layers, requests, prompt in MOE_RUNS:
        t = time.perf_counter()
        m = serve_moe(torch, arch, layers, requests, prompt)
        check(m["shapes"] == expected[arch],
              f"{arch}: attention calls {m['shapes']}, expected "
              f"{expected[arch]}")
        check(m["counts"].get("flash_attention") == sum(
            expected[arch].values()), f"{arch}: flash_attention launched "
              f"{m['counts']}, expected {sum(expected[arch].values())}")
        for key, n in expected[arch].items():
            by_shape[key]["launches"] += n
        log_moe(m, time.perf_counter() - t)
    launches = train_moe(torch)
    train_row["launches"] = launches["flash_attention"]
    bwd_row["launches"] = launches["flash_attention_bwd"]
    rows.extend(by_shape.values())
    rows.extend([train_row, bwd_row])

# --------------------------------------------------------------- phase 11
def xlstm_config(impl: str = "scan", chunk: int = 0, layers=None):
    """xlstm-1.3b, ``layers`` deep (all 48 when None), on the mLSTM route
    ``impl`` with ``mlstm_chunk`` = ``chunk``."""
    import dataclasses

    return dataclasses.replace(family_config(XLSTM_ARCH, layers),
                               mlstm_impl=impl, mlstm_chunk=chunk)


def step_cost(torch, fn, reps: int = XLSTM_STEP_REPS) -> dict:
    """One call of ``fn`` (a cell step): its host ms (:func:`host_ms`) and,
    from a :class:`primed_profile` window over ``reps`` calls, its
    launches and device ms."""
    host = host_ms(torch, fn, reps)
    with primed_profile(torch) as window:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = window.events()
    return {"launches": sum(e.count for e in events) / reps,
            "host_ms": host,
            "device_ms": sum(e.self_device_time_total for e in events)
            / 1e3 / reps}


def xlstm_step_costs(torch, cfg, batch: int) -> dict:
    """The cost of one time step of each cell at full width on ``batch``
    rows (:func:`step_cost`): the mLSTM scan's ``_mlstm_cell_step`` (C
    (B, 4, 1024, 1024) float32) and the sLSTM's ``_slstm_step`` (hd 512),
    on seeded inputs."""
    from repro_torch.nn import recurrent as rec

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    _, H, hd = rec._mlstm_dims(cfg)
    m_carry = (rand(batch, H, hd, hd, scale=1e-2), rand(batch, H, hd),
               torch.zeros((batch, H), device="cuda"))
    m_in = (rand(batch, H, hd), rand(batch, H, hd), rand(batch, H, hd),
            rand(batch, H), rand(batch, H))
    hs = cfg.d_model // H
    s_carry = (rand(batch, H, hs), rand(batch, H, hs).abs() + 1,
               torch.zeros((batch, H, hs), device="cuda"), rand(batch, H, hs))
    r, wx = rand(H, hs, 4 * hs, scale=0.02), rand(batch, H, 4 * hs)
    with torch.inference_mode():
        return {"mLSTM scan step": step_cost(
                    torch, lambda: rec._mlstm_cell_step(m_carry, m_in)),
                "sLSTM step": step_cost(
                    torch, lambda: rec._slstm_step(r, s_carry, wx))}


def xlstm_time_split(torch, run: dict, prefilled) -> dict:
    """The decode steps after ``prefilled`` (the scan route's (logits,
    cache) of the run's prompts; :func:`serve_time_split`), and one layer
    of each mixer kind's prefill on the run's embedded prompts, in a
    :class:`primed_profile` window each (:func:`busy_split`); the whole
    prefill is not profiled (a million launches)."""
    from repro_torch.launch.steps import make_positions
    from repro_torch.models import transformer as tf
    from repro_torch.nn.layers import apply_norm

    cfg, model = run["cfg"], run["model"]
    out = serve_time_split(torch, run, prefilled=prefilled)
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    with torch.inference_mode():
        x = tf.embed_inputs(model, cfg, prompts,
                            make_positions(*prompts.shape, model.device))
        for block, kind in model.blocks():
            if f"{kind} layer prefill" in out:
                continue
            h = apply_norm(block.norm1, x, cfg.norm)
            torch.cuda.synchronize()
            with primed_profile(torch) as window:
                t = time.perf_counter()
                xlstm_mixer(kind)[0](block.mixer, h, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            out[f"{kind} layer prefill"] = busy_split(window, wall)
    return out


def xlstm_mixer(kind: str):
    """(forward, decode) of the xLSTM mixer ``kind``."""
    from repro_torch.nn import recurrent as rec

    if kind == "mlstm":
        return rec.mlstm_forward, rec.mlstm_decode
    return rec.slstm_forward, rec.slstm_decode


class mixer_tap:
    """Within ``with``, the model path's xLSTM mixers
    (``nn.recurrent.mlstm_forward`` and ``slstm_forward``) record each
    call in ``calls``, in layer order: (kind, the mixer, its normed input,
    its result)."""

    def __init__(self):
        from repro_torch.nn import recurrent as rec
        self.rec, self.calls = rec, []

    def __enter__(self):
        self.real = {k: getattr(self.rec, f"{k}_forward")
                     for k in ("mlstm", "slstm")}
        for kind, fwd in self.real.items():
            def tapped(p, x, cfg, return_state=False, kind=kind, fwd=fwd):
                out = fwd(p, x, cfg, return_state=return_state)
                self.calls.append((kind, p, x, out))
                return out
            setattr(self.rec, f"{kind}_forward", tapped)
        return self

    def __exit__(self, *exc):
        for kind, fwd in self.real.items():
            setattr(self.rec, f"{kind}_forward", fwd)


def mixer_errors(torch, got, want) -> dict:
    """max_rel_err of a mixer's (output, state) against another's: "out"
    and "state.<name>" for each tensor of the state."""
    (y, st), (y0, st0) = got, want
    e = {"out": max_rel_err(torch, y, y0)}
    e.update({f"state.{k}": max_rel_err(torch, st[k], st0[k]) for k in st0})
    return e


def over_limits(e: dict, state_limit: float,
                out_limit: float = MIXER_RTOL) -> list:
    """The readings of ``e`` over their limit: the output ``out_limit``,
    the states ``state_limit``, the sLSTM's gelu XLSTM_GELU_RTOL."""
    limit = {"out": out_limit, "gelu": XLSTM_GELU_RTOL}
    return [k for k, v in e.items() if v > limit.get(k, state_limit)]


def worst_of(errs: dict) -> dict:
    """The largest of ``errs`` ({name: error}), named, and the logits'."""
    k = max(errs, key=errs.get)
    return {"worst": k, "err": errs[k], "logits": errs.get("logits")}


def layer_worst(per_layer: list) -> dict:
    """{reading: its largest over the layers} of :func:`mixer_errors`
    dicts (the mixer kinds' states differ)."""
    return {k: max(e[k] for e in per_layer if k in e)
            for k in sorted(set().union(*per_layer))}


def xlstm_route_readings(torch, run: dict, variants: dict,
                         faults: dict | None = None) -> dict:
    """The run's prompts prefilled on the run's config (the scan route),
    its mixers tapped (:class:`mixer_tap`), and on each of ``variants``
    ({name: config}) by the same model: each whole prefill against the
    scan one (:func:`prefill_errors`), and each layer's mixer on the
    variant's config fed the scan route's input to that layer, against
    the scan route's result (no error carried over from the layers
    before). ``faults`` ({name: (config, context)}) run the first mLSTM
    layer so. Also returns the scan route's (logits, cache) and the tap's
    calls. No limit is held here."""
    from repro_torch.models import transformer as tf

    cfg, model = run["cfg"], run["model"]
    device = model.device.type
    prompts = torch.from_numpy(run["prompts"]).to(model.device)
    out = {"times": {}, "whole": {}, "per_layer": {n: [] for n in variants},
           "planted": {}}
    with torch.inference_mode():
        with mixer_tap() as tap:
            t = time.perf_counter()
            out["scan"] = tf.prefill(model, cfg, prompts)
            sync(torch, device)
            out["times"]["scan"] = time.perf_counter() - t
        for name, c in variants.items():
            t = time.perf_counter()
            other = tf.prefill(model, c, prompts)
            sync(torch, device)
            out["times"][name] = time.perf_counter() - t
            out["whole"][name] = prefill_errors(torch, cfg, other,
                                                out["scan"])
            del other
        for kind, p, h, want in tap.calls:
            for name, c in variants.items():
                out["per_layer"][name].append(mixer_errors(
                    torch, xlstm_mixer(kind)[0](p, h, c, return_state=True),
                    want))
        kind, p, h, want = next(c for c in tap.calls if c[0] == "mlstm")
        for name, (c, ctx) in (faults or {}).items():
            with ctx:
                out["planted"][name] = mixer_errors(
                    torch, xlstm_mixer(kind)[0](p, h, c, return_state=True),
                    want)
    out["calls"] = tap.calls
    return out


def check_xlstm_routes(torch, run: dict, chunk: int = XLSTM_CHUNK) -> dict:
    """The chunkwise route (``mlstm_chunk`` = ``chunk``) against the scan
    route (the run's config) on the run's prompts
    (:func:`xlstm_route_readings`). Layer by layer, each mixer fed the
    scan route's input: the output within MIXER_RTOL and every state
    within XLSTM_STATE_RTOL, and the chunkwise carry without decay_in,
    planted in the first mLSTM layer, over a limit. The whole prefill:
    the last logits and every layer's state within XLSTM_ROUTE_RTOL of
    each tensor's largest magnitude. Returns the readings and the scan
    route's (logits, cache)."""
    import dataclasses

    from repro_torch.nn import recurrent as rec

    cfg = run["cfg"]
    chunkwise = dataclasses.replace(cfg, mlstm_impl="chunkwise",
                                    mlstm_chunk=chunk)
    r = xlstm_route_readings(torch, run, {"chunkwise": chunkwise}, {
        "carry without decay_in": (chunkwise, swapped(
            rec, "_mlstm_chunk", carry_without_decay_in(rec._mlstm_chunk)))})
    per_layer = r["per_layer"]["chunkwise"]
    for i, e in enumerate(per_layer):
        check(not over_limits(e, XLSTM_STATE_RTOL),
              f"layer {i} chunkwise vs scan mixer: {e} (limits "
              f"{MIXER_RTOL}, states {XLSTM_STATE_RTOL})")
    missed = [n for n, e in r["planted"].items()
              if not over_limits(e, XLSTM_STATE_RTOL)]
    check(not missed, f"planted faults not caught: {r['planted']}")
    whole = worst_of(r["whole"]["chunkwise"])
    check(XLSTM_ROUTE_RTOL is None or whole["err"] <= XLSTM_ROUTE_RTOL,
          f"chunkwise vs scan prefill: {whole} (limit {XLSTM_ROUTE_RTOL})")
    return {"scan_prefill_s": r["times"]["scan"],
            "chunkwise_prefill_s": r["times"]["chunkwise"],
            "whole": whole, "layer_worst": layer_worst(per_layer),
            "planted": r["planted"], "scan": r["scan"]}


def time_xlstm_prefill(torch, cfg, batch: int, seq: int) -> dict:
    """One prefill of ``batch`` x ``seq`` seeded tokens through a model of
    ``cfg`` (random weights, seed SEED + 11): seconds (ending in a
    synchronise), tokens/s and peak memory."""
    import numpy as np

    from repro_torch.models import transformer as tf

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    model = tf.init_params(cfg, g, "cuda")
    tokens = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    x = torch.from_numpy(tokens).to(model.device)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t = time.perf_counter()
        logits, _ = tf.prefill(model, cfg, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    check(tuple(logits.shape) == (batch, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"chunkwise prefill logits {tuple(logits.shape)}")
    return {"batch": batch, "seq": seq, "layers": cfg.num_layers,
            "prefill_s": wall, "tokens_per_s": batch * seq / wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


class palindromic_convs:
    """Within ``with``, every convolution kernel of ``model`` reads the same
    forwards and backwards, w[k] = (w[k] + w[W - 1 - k]) / 2; restored
    after. The reference's decode step weights x[t - k] by w[W - 1 - k]
    where its prefill weights it by w[k], so only with such kernels can a
    decode continue a prefill."""

    def __init__(self, torch, model):
        self.torch = torch
        self.convs = [p for n, p in model.named_parameters()
                      if n.endswith("conv.w")]

    def __enter__(self):
        self.saved = [p.detach().clone() for p in self.convs]
        with self.torch.no_grad():
            for p in self.convs:
                p.copy_((p + p.flip(0)) / 2)
        return self

    def __exit__(self, *exc):
        with self.torch.no_grad():
            for p, w in zip(self.convs, self.saved):
                p.copy_(w)


def conv_state_unshifted(real):
    """``causal_conv_step`` that keeps its old state: every decode step
    convolves with the prefill's last inputs."""
    def step(p, x_t, state):
        out, _ = real(p, x_t, state)
        return out, state
    return step


def conv_unrounded(real):
    """``causal_conv`` whose output is not rounded to its input's dtype."""
    return lambda p, x: real(p, x.float())


def mixer_continuation(torch, p, kind: str, cfg, h, prompt: int):
    """The mixer's prefill of ``h[:, :prompt]``, then one decode step per
    later position of ``h``: (the decode steps' outputs, the final
    state)."""
    fwd, dec = xlstm_mixer(kind)
    _, state = fwd(p, h[:, :prompt], cfg, return_state=True)
    ys = []
    for t in range(prompt, h.shape[1]):
        y, state = dec(p, h[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def xlstm_continuity_readings(torch, run: dict, prompt: int, steps: int
                              ) -> dict:
    """Prefill ``prompt`` of the run's prompt tokens and decode ``steps``
    more of them (fed the known tokens) against a prefill of ``prompt`` +
    ``steps``, its mixers tapped, all with palindromic kernels
    (:class:`palindromic_convs`): the whole model (the last logits and
    every layer's state, :func:`prefill_errors`), and layer by layer on
    the full prefill's inputs (:func:`mixer_continuation` against the
    full prefill's outputs at the decoded positions and its final state).
    Layer by layer also: against the mLSTM's full prefill with its
    convolution left unrounded (the conv dtype quirk removed); the decode
    steps' outputs kept to 4 significant bits (the control, each layer);
    the decode's conv state left unshifted (a fault) and the random
    kernels (the reversal) in the first mLSTM layer. No limit is held
    here."""
    from repro_torch.models import transformer as tf
    from repro_torch.nn import recurrent as rec

    cfg, model = run["cfg"], run["model"]
    tokens = torch.from_numpy(run["prompts"][:, :prompt + steps]).to(
        model.device)
    out = {"per_layer": [], "unrounded": [], "control": []}
    with torch.inference_mode(), palindromic_convs(torch, model):
        logits, cache = tf.prefill(model, cfg, tokens[:, :prompt])
        for t in range(prompt, prompt + steps):
            logits, cache = tf.decode_step(model, cfg, cache,
                                           tokens[:, t:t + 1], t)
        check(bool(torch.isfinite(logits).all()), "decode logits")
        with mixer_tap() as tap:
            full = tf.prefill(model, cfg, tokens)
        out["whole"] = prefill_errors(torch, cfg, (logits, cache), full)
        del full, cache
        for kind, p, h, (y, st) in tap.calls:
            got = mixer_continuation(torch, p, kind, cfg, h, prompt)
            out["per_layer"].append(mixer_errors(torch, got,
                                                 (y[:, prompt:], st)))
            coarse = round_to_bits(torch, got[0].float().clone(), 4)
            out["control"].append(mixer_errors(torch, (coarse, got[1]),
                                               (y[:, prompt:], st)))
            del coarse
            if kind == "mlstm":
                with swapped(rec, "causal_conv",
                             conv_unrounded(rec.causal_conv)):
                    yu, su = rec.mlstm_forward(p, h, cfg, return_state=True)
                out["unrounded"].append(mixer_errors(torch, got,
                                                     (yu[:, prompt:], su)))
        kind, p, h, (y, st) = next(c for c in tap.calls if c[0] == "mlstm")
        with swapped(rec, "causal_conv_step",
                     conv_state_unshifted(rec.causal_conv_step)):
            out["conv state unshifted"] = mixer_errors(
                torch, mixer_continuation(torch, p, kind, cfg, h, prompt),
                (y[:, prompt:], st))
    with torch.inference_mode():
        y, st = rec.mlstm_forward(p, h, cfg, return_state=True)
        out["reversed kernels"] = mixer_errors(
            torch, mixer_continuation(torch, p, kind, cfg, h, prompt),
            (y[:, prompt:], st))
    return out


def check_xlstm_continuity(torch, run: dict,
                           prompt: int = XLSTM_CONT_PROMPT,
                           steps: int = XLSTM_GEN) -> dict:
    """:func:`xlstm_continuity_readings`, held: layer by layer the decode
    steps' outputs within XLSTM_CONT_OUT_RTOL and the final states within
    XLSTM_CONT_RTOL (the conv dtype quirk: the decode's convolution is not
    rounded to bf16 where the prefill's is), each layer's 4-bit control and
    the unshifted conv state over them; the whole model within
    XLSTM_CONT_WHOLE_RTOL. The random
    kernels' gap (the reference's reversal) and the gap with the quirk
    removed are reported."""
    r = xlstm_continuity_readings(torch, run, prompt, steps)
    for i, (e, c) in enumerate(zip(r["per_layer"], r["control"])):
        check(not over_limits(e, XLSTM_CONT_RTOL, XLSTM_CONT_OUT_RTOL),
              f"layer {i} decode vs prefill: {e} (limits "
              f"{XLSTM_CONT_OUT_RTOL}, states {XLSTM_CONT_RTOL})")
        check(c["out"] > XLSTM_CONT_OUT_RTOL,
              f"layer {i}: the 4-bit control {c['out']} is within the "
              f"limit {XLSTM_CONT_OUT_RTOL}")
    check(bool(over_limits(r["conv state unshifted"], XLSTM_CONT_RTOL,
                           XLSTM_CONT_OUT_RTOL)),
          f"planted fault not caught: {r['conv state unshifted']}")
    whole = worst_of(r["whole"])
    check(XLSTM_CONT_WHOLE_RTOL is None
          or whole["err"] <= XLSTM_CONT_WHOLE_RTOL,
          f"prefill + decode vs prefill: {whole} (limit "
          f"{XLSTM_CONT_WHOLE_RTOL})")
    return {"whole": whole, "layer_worst": layer_worst(r["per_layer"]),
            "unrounded_worst": layer_worst(r["unrounded"]),
            "control_least": min(c["out"] for c in r["control"]),
            "conv state unshifted": r["conv state unshifted"],
            "reversed kernels": r["reversed kernels"]}


def swap_i_f(torch, step):
    """``_slstm_step`` with the i and f gates swapped: their columns of
    ``wx_t`` and of each head's ``r_gates`` trade places."""
    def swapped_step(p_r, carry, wx_t):
        def perm(t):
            z, i, f, o = t.split(t.shape[-1] // 4, dim=-1)
            return torch.cat([z, f, i, o], dim=-1)
        return step(perm(p_r), carry, perm(wx_t))
    return swapped_step


def m_held_at_zero(i_pre, log_f, m):
    """``_gates`` with the stabiliser held at 0."""
    return m * 0, i_pre.exp(), (log_f + m).exp()


def carry_without_decay_in(chunk):
    """``_mlstm_chunk`` whose carry drops the previous chunk's C and n (no
    decay_in term); the chunk's outputs stay right."""
    def faulty(Cin, nin, m_in, *xs):
        _, _, m, h = chunk(Cin, nin, m_in, *xs)
        C, n, _, _ = chunk(Cin * 0, nin * 0, m_in, *xs)
        return C, n, m, h
    return faulty


class gelu_tap:
    """Within ``with``, ``nn.recurrent.gelu`` (whatever it is then) also
    records its last input and output."""

    def __init__(self):
        from repro_torch.nn import recurrent as rec
        self.rec = rec

    def __enter__(self):
        self.real = self.rec.gelu

        def tapped(u):
            self.u, self.out = u, self.real(u)
            return self.out
        self.rec.gelu = tapped
        return self

    def __exit__(self, *exc):
        self.rec.gelu = self.real


def gelu_tanh64(torch, u):
    """The reference's gelu (``jax.nn.gelu``, the tanh form) in float64."""
    import math

    u = u.double()
    return 0.5 * u * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (u + 0.044715 * u ** 3)))


def check_xlstm_mixers(torch, cfg, device: str = "cuda",
                       batch: int = XLSTM_LAYER[0], seq: int = XLSTM_LAYER[1],
                       chunk: int = XLSTM_CHUNK) -> dict:
    """One layer of each mixer of ``cfg`` (random weights, seed SEED + 11,
    as a serving model holds them) on a seeded (batch, seq, d_model) input
    in the compute dtype: the mLSTM on the scan and the chunkwise route,
    the sLSTM. Each is held against the same function computed with its
    float32 arithmetic in float64 (a copy cast with ``.double()``: its
    products and roundings to bf16 unchanged, see ``nn/recurrent.py``):
    the output within MIXER_RTOL and every state within XLSTM_STATE_RTOL
    of its largest magnitude; the sLSTM's gelu on its own inputs within
    XLSTM_GELU_RTOL of the tanh form in float64. Faults planted in the
    route under test alone: the mLSTM stabiliser m held at 0 and the
    prefill's conv output left unrounded (scan route), the chunkwise carry
    without decay_in, the sLSTM's i and f gates swapped and the exact
    ``F.gelu``. Returns the readings; ``missed`` names the faults that no
    limit caught (the caller decides)."""
    import copy
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.models import transformer as tf
    from repro_torch.nn import recurrent as rec
    from repro_torch.nn.layers import compute_dtype

    g = torch.Generator(device=device)
    g.manual_seed(SEED + 11)
    model = tf.init_params(dataclasses.replace(cfg, num_layers=2), g, device)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device=device).to(compute_dtype(device))
    mixers = {k: b.mixer for b, k in model.blocks()}
    del model
    scan = dataclasses.replace(cfg, mlstm_impl="scan", mlstm_chunk=0)
    chunkwise = dataclasses.replace(cfg, mlstm_impl="chunkwise",
                                    mlstm_chunk=chunk)
    cases = {"mLSTM scan": ("mlstm", scan, {
                 "m held at 0": swapped(rec, "_gates", m_held_at_zero),
                 "prefill conv unrounded": swapped(
                     rec, "causal_conv", conv_unrounded(rec.causal_conv))}),
             "mLSTM chunkwise": ("mlstm", chunkwise, {
                 "carry without decay_in": swapped(
                     rec, "_mlstm_chunk",
                     carry_without_decay_in(rec._mlstm_chunk))}),
             "sLSTM": ("slstm", cfg, {
                 "i and f swapped": swapped(rec, "_slstm_step",
                                            swap_i_f(torch, rec._slstm_step)),
                 "exact F.gelu": swapped(rec, "gelu", F.gelu)})}

    def run(p, kind, c):
        with torch.inference_mode(), gelu_tap() as tap:
            got = xlstm_mixer(kind)[0](p, x, c, return_state=True)
        e = {"gelu": max_rel_err(torch, tap.out, gelu_tanh64(torch, tap.u))
             } if kind == "slstm" else {}
        return got, e

    out = {"cases": {}, "planted": {}, "missed": []}
    for name, (kind, c, faults) in cases.items():
        p = mixers[kind]
        want, _ = run(copy.deepcopy(p).double(), kind, c)
        got, extra = run(p, kind, c)
        e = {**mixer_errors(torch, got, want), **extra}
        check(not over_limits(e, XLSTM_STATE_RTOL),
              f"{name} vs float64: {e} (limits out {MIXER_RTOL}, states "
              f"{XLSTM_STATE_RTOL}, gelu {XLSTM_GELU_RTOL})")
        out["cases"][name] = e
        for fault, ctx in faults.items():
            with ctx:
                bad, extra = run(p, kind, c)
            e = {**mixer_errors(torch, bad, want), **extra}
            out["planted"][f"{name}: {fault}"] = e
            if not over_limits(e, XLSTM_STATE_RTOL):
                out["missed"].append(f"{name}: {fault}")
        del want, got
    sync(torch, device)
    return out


def train_xlstm(torch) -> dict:
    """Phase 11's training: ``check_fits`` passes the full 48-layer model;
    ``launch.train.run`` on xlstm-1.3b at full width, XLSTM_TRAIN_LAYERS
    deep, on the chunkwise route (chunk XLSTM_CHUNK), XLSTM_TRAIN_WARMUP +
    XLSTM_TRAIN_STEPS steps of TRAIN_BATCH x XLSTM_TRAIN_SEQ Markov tokens
    (:func:`train_model`: the first loss within FIRST_LOSS_TOL of
    ln(50304))."""
    import gc

    from repro_torch.launch import train as ptrain

    full = xlstm_config()
    ptrain.check_fits(full, torch.device("cuda"))
    cfg = xlstm_config("chunkwise", XLSTM_CHUNK, XLSTM_TRAIN_LAYERS)
    run = train_model(torch, cfg, seq=XLSTM_TRAIN_SEQ,
                      warmup=XLSTM_TRAIN_WARMUP, steps=XLSTM_TRAIN_STEPS)
    out = {k: run[k] for k in ("losses", "times", "step_s", "tokens_per_s",
                               "peak_gib", "params", "wall_s")}
    out["full_state_gb"] = 16 * full.param_count() / 1e9
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_xlstm_family(torch) -> dict:
    """Phase 11: xlstm-1.3b at full width and depth, random weights (seed
    0) as a serving model holds them, through ``Server.generate`` on the
    scan route (:func:`serve_model`; no kernel launched); the cell steps'
    costs; the chunkwise route against the scan route, then the decode
    steps and one layer of each kind profiled; the chunkwise prefill at
    XLSTM_LONG; continuity; one layer of each mixer against float64 with
    planted faults; training. Every check fails the run, a missed planted
    fault too."""
    import gc

    out: dict = {}
    cfg = xlstm_config()
    torch.cuda.reset_peak_memory_stats()
    run = serve_model(torch, cfg, requests=XLSTM_REQUESTS,
                      prompt=XLSTM_PROMPT, gen=XLSTM_GEN)
    check(not any(run["counts"].values()),
          f"xlstm launched kernels: {run['counts']}")
    tm = run["timings"]
    out["serve"] = {"params": run["params"], "init_s": run["init_s"],
                    "prefill_s": tm["prefill_s"],
                    "decode_ms": tm["decode_s"] * 1e3 / XLSTM_GEN,
                    "decode_tokens_per_s": XLSTM_REQUESTS * XLSTM_GEN
                    / tm["decode_s"],
                    "generate_peak_gib": run["peak_gib"],
                    "out_head": run["out"][0, :8].tolist()}
    out["bound"] = decode_bound(run["model"], cfg, XLSTM_REQUESTS,
                                XLSTM_PROMPT, XLSTM_GEN)
    out["steps"] = xlstm_step_costs(torch, cfg, XLSTM_REQUESTS)
    t = time.perf_counter()
    out["routes"] = check_xlstm_routes(torch, run)
    out["routes"]["check_s"] = time.perf_counter() - t
    out["split"] = xlstm_time_split(torch, run, out["routes"].pop("scan"))
    t = time.perf_counter()
    out["continuity"] = check_xlstm_continuity(torch, run)
    out["continuity"]["check_s"] = time.perf_counter() - t
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["long"] = time_xlstm_prefill(
        torch, xlstm_config("chunkwise", XLSTM_CHUNK, XLSTM_LONG_LAYERS),
        *XLSTM_LONG)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["mixers"] = check_xlstm_mixers(torch, cfg)
    out["mixers"]["check_s"] = time.perf_counter() - t
    check(not out["mixers"]["missed"],
          f"planted faults not caught: {out['mixers']['missed']} "
          f"{out['mixers']['planted']}")
    out["train"] = train_xlstm(torch)
    return out


def log_xlstm(x: dict, card: str) -> None:
    """Phase 11's lines, each with the card's name and power limit."""
    sv, bd, split = x["serve"], x["bound"], x["split"]
    dec = split["decode"]
    log(f"phase 11 {XLSTM_ARCH}: 48 layers (no cut), {sv['params']} "
        f"parameters built in {sv['init_s']:.3f} s; {XLSTM_REQUESTS} x "
        f"{XLSTM_PROMPT} prompt + {XLSTM_GEN} decode steps on the scan route"
        f": prefill {sv['prefill_s']:.3f} s, decode {sv['decode_ms']:.3f} ms"
        f" per step ({sv['decode_tokens_per_s']:.1f} tokens/s) against a "
        f"bound of {bd['bound_ms']:.3f} ms ({bd['weight_bytes']} weight "
        f"bytes + {bd['state_bytes']} state bytes read and written a step "
        f"at 3.35 TB/s); profiled decode: {dec.get('launches')} launches a "
        f"step, device {dec.get('device_ms')} ms, busy "
        f"{dec.get('busy_share')}; peak device memory "
        f"{sv['generate_peak_gib']:.3f} GiB in generate; first tokens "
        f"{sv['out_head']} [{card}]")
    for name, c in x["steps"].items():
        log(f"phase 11 one {name} at full width, B = {XLSTM_REQUESTS}: "
            f"{c['launches']:.1f} launches, host {c['host_ms']:.4f} ms, "
            f"device {c['device_ms']:.4f} ms [{card}]")
    log(f"phase 11 time split (decode, and one layer of each kind's "
        f"prefill): {json.dumps(split)} [{card}]")
    r = x["routes"]
    log(f"phase 11 chunkwise (chunk {XLSTM_CHUNK}) vs scan prefill of "
        f"{XLSTM_REQUESTS} x {XLSTM_PROMPT}: scan {r['scan_prefill_s']:.3f} "
        f"s, chunkwise {r['chunkwise_prefill_s']:.3f} s; layer by layer "
        f"worst {json.dumps(r['layer_worst'])} (limits {MIXER_RTOL}, states "
        f"{XLSTM_STATE_RTOL}); planted {json.dumps(r['planted'])}; whole "
        f"prefill {json.dumps(r['whole'])} (limit {XLSTM_ROUTE_RTOL}); "
        f"{r['check_s']:.3f} s [{card}]")
    c = x["continuity"]
    log(f"phase 11 continuity, prefill {XLSTM_CONT_PROMPT} + {XLSTM_GEN} "
        f"decode steps vs prefill {XLSTM_CONT_PROMPT + XLSTM_GEN} with "
        f"palindromic kernels: {json.dumps(c)} (limits layer by layer "
        f"{XLSTM_CONT_OUT_RTOL}, states {XLSTM_CONT_RTOL}; whole "
        f"{XLSTM_CONT_WHOLE_RTOL}) [{card}]")
    lg = x["long"]
    log(f"phase 11 chunkwise prefill {lg['batch']} x {lg['seq']} through "
        f"{lg['layers']} layers (reduced: num_layers 48 -> "
        f"{XLSTM_LONG_LAYERS} for this timing): {lg['prefill_s']:.3f} s, "
        f"{lg['tokens_per_s']:.1f} tokens/s, peak {lg['peak_gib']:.3f} GiB "
        f"[{card}]")
    m = x["mixers"]
    log(f"phase 11 one layer of each mixer (B x S = {XLSTM_LAYER}) vs "
        f"float64: {json.dumps(m['cases'])} (limits out {MIXER_RTOL}, "
        f"states {XLSTM_STATE_RTOL}, gelu {XLSTM_GELU_RTOL}); planted "
        f"{json.dumps(m['planted'])}; missed {m['missed']}; "
        f"{m['check_s']:.3f} s [{card}]")
    tr = x["train"]
    log(f"phase 11 train {XLSTM_ARCH} cut to {XLSTM_TRAIN_LAYERS} layers "
        f"({tr['params']} parameters; the full model's 16 bytes a "
        f"parameter {tr['full_state_gb']:.1f} GB pass check_fits), chunkwise"
        f", {XLSTM_TRAIN_WARMUP} + {XLSTM_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {XLSTM_TRAIN_SEQ} tokens: losses "
        + " ".join(f"{v:.4f}" for v in tr["losses"])
        + "; step s " + " ".join(f"{v:.3f}" for v in tr["times"])
        + f"; median timed step {tr['step_s']:.3f} s, "
        f"{tr['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{tr['peak_gib']:.3f} GiB; run {tr['wall_s']:.3f} s [{card}]")


# --------------------------------------------------------------- phase 12
def host_copy(state: dict) -> dict:
    """A copy on the host of port train ``state``'s tensors (by name),
    step and count."""
    def copy(named):
        return {n: t.detach().to("cpu", copy=True) for n, t in named}
    return {"params": copy(state["params"].named_parameters()),
            "m": copy(state["opt"]["m"].items()),
            "v": copy(state["opt"]["v"].items()),
            "step": int(state["step"]), "count": int(state["opt"]["count"])}


def state_mismatches(torch, state: dict, want: dict) -> list:
    """The tensors of port train ``state`` (on the host) whose dtype,
    shape or bits differ from :func:`host_copy` ``want``, and a differing
    step or count."""
    got = host_copy(state) if state["params"].lm_head.device.type != "cpu" \
        else {"params": dict(state["params"].named_parameters()),
              "m": state["opt"]["m"], "v": state["opt"]["v"],
              "step": int(state["step"]), "count": int(state["opt"]["count"])}
    bad = []
    for part in ("params", "m", "v"):
        if set(got[part]) != set(want[part]):
            bad.append(f"{part}: names differ")
            continue
        for name, w in want[part].items():
            g = got[part][name].detach()
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not torch.equal(g.contiguous().view(torch.uint8),
                                       w.contiguous().view(torch.uint8)):
                bad.append(f"{part}:{name}")
    bad.extend(f"{k} {got[k]} != {want[k]}" for k in ("step", "count")
               if got[k] != want[k])
    return bad


def elastic_continuation(torch, cfg=None, device: str = "cuda",
                         batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                         steps: int = ELASTIC_STEPS) -> dict:
    """Phase 12a: ``launch.train.run`` trains ``cfg`` (default
    ``MODEL_ARCH`` at full width cut to ELASTIC_LAYERS) for ``steps``
    steps of ``batch`` x ``seq`` with a
    checkpoint at the last (its save timed), and the state at that step is
    copied to the host; ``steps`` more steps on the live state are the
    uninterrupted run. ``train.elastic.elastic_restart`` restores
    snapshot(steps) onto the CPU, where every tensor must equal the host
    copy bit for bit, and again onto ``device``, where ``steps`` more steps
    (``train.elastic.continue_training``) must give the uninterrupted
    run's losses exactly (the kernels are deterministic), at the same
    batch indices, and launch what ``launches_per_step`` gives for the
    config each step, every attention launch forward and backward on
    ``wgmma``."""
    import dataclasses
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.versioned import Version
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as psteps
    from repro_torch.launch import train as ptrain
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import elastic

    if cfg is None:
        cfg = dataclasses.replace(get_config(MODEL_ARCH),
                                  num_layers=ELASTIC_LAYERS)
    on_card = device == "cuda"
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"layers": cfg.num_layers}
    real_save = ckpt_mod.CheckpointManager.save
    saves: list[float] = []

    def timed_save(self, *args, **kw):
        t = time.perf_counter()
        v = real_save(self, *args, **kw)
        saves.append(time.perf_counter() - t)
        return v

    def launched(n_steps: int) -> dict:
        counts = ops.launch_counts()
        routes = ops.route_counts()
        want = {k: v * n_steps if on_card else 0
                for k, v in launches_per_step(cfg).items()}
        for name, n in want.items():
            check(counts[name] == n, f"elastic: {name} launched "
                                     f"{counts[name]} times, expected {n}")
        for name in ("flash_attention", "flash_attention_bwd"):
            check(routes[name]["wgmma"] == want[name],
                  f"elastic: {name} routes {routes[name]}")
        return {k: counts[k] for k in want}

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        with swapped(ckpt_mod.CheckpointManager, "save", timed_save):
            first, state = ptrain.run(cfg, steps=steps, batch=batch,
                                      seq=seq, ckpt_dir=tmp, ckpt_every=1,
                                      log_every=100, seed=SEED,
                                      device=device)
        check(len(saves) == 1, f"{len(saves)} checkpoints written")
        files = list(pathlib.Path(tmp).glob("*.npz"))
        out["ckpt_bytes"] = sum(f.stat().st_size for f in files)
        out["save_s"] = saves[0]
        at_ckpt = host_copy(state)
        ops.reset_launch_counts()
        straight = elastic.continue_training(cfg, state, steps_n=steps,
                                             batch=batch, seq=seq, seed=SEED)
        sync(torch, device)
        out["launches_uninterrupted"] = launched(steps)
        del state
        # the driver's dataflow holds its state box in a reference cycle
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        like = psteps.reference_state_like(cfg)
        mgr = ckpt_mod.CheckpointManager(tmp)
        t = time.perf_counter()
        host = elastic.elastic_restart(cfg, mgr, like, make_local_mesh("cpu"),
                                       version=Version(0, steps))
        out["restore_cpu_s"] = time.perf_counter() - t
        bad = state_mismatches(torch, host, at_ckpt)
        check(not bad, f"elastic restore onto the CPU differs from the "
                       f"card's state at step {steps}: {bad[:5]}")
        del host, at_ckpt
        t = time.perf_counter()
        card = elastic.elastic_restart(cfg, mgr, like,
                                       make_local_mesh(device),
                                       version=Version(0, steps))
        sync(torch, device)
        out["restore_card_s"] = time.perf_counter() - t
        check(int(card["step"]) == steps, f"restored step {card['step']}")
        ops.reset_launch_counts()
        resumed = elastic.continue_training(cfg, card, steps_n=steps,
                                            batch=batch, seq=seq, seed=SEED)
        sync(torch, device)
        out["launches"] = launched(steps)
        del card
        gc.collect()
    check(list(resumed) == list(range(steps, 2 * steps)),
          f"resumed at batch indices {list(resumed)}")
    check(resumed == straight, f"losses after the restart {resumed}, "
                               f"uninterrupted {straight}")
    out.update(first=[first[i] for i in sorted(first)],
               uninterrupted=[straight[i] for i in sorted(straight)],
               resumed=[resumed[i] for i in sorted(resumed)])
    return out


def predict_against_card(torch, measured: dict) -> dict:
    """Phase 12b: the dry-run's count (``launch.dryrun.count_step`` on meta
    tensors standing for the card) of phase 5's serving prefill and phase
    8c's training step, beside what those phases measured: the predicted
    peak (the step's arguments and the most it holds at once) within
    PEAK_RTOL of the measured one less what earlier phases left allocated,
    the predicted flops and bytes, and the roofline row of each with the
    share of the measured time its dominant term accounts for."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun

    cfg = get_config(MODEL_ARCH)
    out = {}
    for name, kind, batch, seq in (
            ("prefill", "prefill", MODEL_REQUESTS, MODEL_PROMPT),
            ("train", "train", TRAIN_BATCH, TRAIN_SEQ)):
        c = dryrun.count_step(cfg, kind, batch, seq)
        m = measured[name]
        pred = c["argument_bytes"] + c["peak_bytes"]
        seen = m["peak_bytes"] - m["left_bytes"]
        rel = (pred - seen) / seen
        row = roofline.cell_roofline(cfg, ShapeCell(name, seq, batch, kind),
                                     c)
        out[name] = {
            "batch": batch, "seq": seq, "count_s": c["count_s"],
            "predicted_peak_gib": pred / 2**30,
            "measured_peak_gib": seen / 2**30, "peak_rel_err": rel,
            "flops": c["flops"], "tensor_core_flops": c["tensor_core_flops"],
            "hbm_bytes": c["hbm_bytes"], "kernels": c["kernels"],
            "compute_s": row["compute_s"], "memory_s": row["memory_s"],
            "dominant": row["dominant"],
            "roofline_fraction": row["roofline_fraction"],
            "measured_s": m["s"], "bound_share": row["bound_s"] / m["s"]}
        check(abs(rel) <= PEAK_RTOL,
              f"dry-run {name}: predicted peak {pred / 2**30:.3f} GiB, "
              f"measured {seen / 2**30:.3f} GiB ({rel:+.3%}, limit "
              f"{PEAK_RTOL})")
    return out


def log_phase12(el: dict, pred: dict, card: str) -> None:
    log(f"phase 12a elastic restart, {MODEL_ARCH} at full width cut to "
        f"{el['layers']} layers, {ELASTIC_STEPS} + {ELASTIC_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: checkpoint {el['ckpt_bytes']} bytes, "
        f"save {el['save_s']:.3f} s "
        f"({el['ckpt_bytes'] / el['save_s'] / 1e9:.3f} GB/s), restore onto "
        f"the CPU {el['restore_cpu_s']:.3f} s (bit-equal to the card's "
        f"state), onto the card {el['restore_card_s']:.3f} s; losses "
        f"{el['first']} then uninterrupted {el['uninterrupted']}, after the "
        f"restart {el['resumed']} (equal); launches over the "
        f"{ELASTIC_STEPS} resumed steps {el['launches']} [{card}]")
    for name, r in pred.items():
        log(f"phase 12b dry-run vs card, {name} {r['batch']} x {r['seq']}: "
            f"peak predicted {r['predicted_peak_gib']:.3f} GiB, measured "
            f"{r['measured_peak_gib']:.3f} GiB ({r['peak_rel_err']:+.3%}, "
            f"limit {PEAK_RTOL}); flops {r['flops']:.4e} (tensor cores "
            f"{r['tensor_core_flops']:.4e}), HBM bytes {r['hbm_bytes']:.4e}"
            f", kernels {r['kernels']}; roofline compute {r['compute_s']:.4f}"
            f" s, memory {r['memory_s']:.4f} s, {r['dominant']}-bound, "
            f"roofline fraction {r['roofline_fraction']:.3f}; measured "
            f"{r['measured_s']:.4f} s, the bound {r['bound_share']:.3f} of "
            f"it; counted in {r['count_s']:.2f} s [{card}]")


# --------------------------------------------------------------- phase 13
class plane_taps:
    """Within ``with``, plants one fault of the elastic and durable graph
    plane, for phase 13's checks to catch; no package file changes.
    ``fault`` is one of :data:`PLANE_FAULTS`:

    - ``split deletes left out of the stamp mirror``: at a cutover's
      activation seal the source shard of ``store`` applies its migration
      deletes to the host stamps, but its device ``deleted`` mirror keeps
      the moved rows live (views built from the stamps see them on both
      shards);
    - ``mirrors published one version stale``: every replica plan of
      ``store`` carries the mirror rows of the version published before
      it, under its own version;
    - ``recovery without the plan events``: ``GraphWal.read_control``
      drops the control log's plan events, so a recovery replays no
      cutover past its checkpoint (no ``store``: it has none yet)."""

    def __init__(self, fault: str, store=None):
        check(fault in PLANE_FAULTS, f"unknown fault {fault!r}")
        self.fault, self.store = fault, store

    def __enter__(self):
        import dataclasses

        import numpy as np
        import torch

        from repro_torch.graph import wal
        from repro_torch.graph.dyngraph import MAXV
        sg = self.store
        self.saved = []
        if self.fault == PLANE_FAULTS[0]:
            real = sg._dispatch_migration

            def dispatch(source, target, new_plan, epoch):
                shard = sg.shards[source]
                e = shard.n_edges
                live = np.flatnonzero(shard.deleted[:e] == MAXV)
                rows = live[new_plan.assign(shard.dst[live].astype(np.int64))
                            != source]
                apply = shard.apply

                def leaky_apply(batch):
                    apply(batch)
                    if batch.version.epoch == epoch and rows.size:
                        shard._d_deleted[torch.from_numpy(rows).to(
                            shard.device)] = MAXV
                        del shard.apply          # one activation seal only
                shard.apply = leaky_apply
                return real(source, target, new_plan, epoch)
            self.saved.append((sg, "_dispatch_migration"))
            sg._dispatch_migration = dispatch
        elif self.fault == PLANE_FAULTS[1]:
            real = sg.build_replica_plan
            last = []

            def stale_plan(version, hot_ids, use_kernel=None):
                plan = real(version, hot_ids, use_kernel=use_kernel)
                prev = last[-1] if last else None
                last.append(version)
                if prev is None or prev == version:
                    return plan
                old = real(prev, hot_ids, use_kernel=use_kernel)
                return dataclasses.replace(plan, mirror_src=old.mirror_src,
                                           mirror_dst=old.mirror_dst)
            self.saved.append((sg, "build_replica_plan"))
            sg.build_replica_plan = stale_plan
        else:
            real = wal.GraphWal.read_control

            def no_plan_events(directory):
                meta, _events, commits = real(directory)
                return meta, [], commits
            self.saved.append((wal.GraphWal, "read_control",
                               staticmethod(real)))
            wal.GraphWal.read_control = staticmethod(no_plan_events)
        return self

    def __exit__(self, *exc):
        for owner, name, *value in self.saved:
            if value:
                setattr(owner, name, value[0])
            else:
                delattr(owner, name)      # the instance's own attribute


def view_digest(view) -> str:
    """SHA-256 of a join view's five CSR tensors on the host, with their
    dtypes and shapes: equal digests are byte-equal views."""
    import hashlib

    from repro_torch.device import to_host
    h = hashlib.sha256()
    for f in ("offsets", "src", "dst", "out_degree", "in_degree"):
        a = to_host(getattr(view, f))
        h.update(f"{f} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def rebuilt_view(sg, version):
    """The stitched view at ``version`` rebuilt from the stamps: every
    cache of the store dropped first, so each shard's view is a full
    rebuild through ``liveness_mask`` on its device stamp mirrors."""
    sg._views.clear()
    for shard in sg.shards:
        shard._views.clear()
    return sg.join_view(version)


def check_stamp_mirrors(sg, what: str) -> None:
    """Every shard's device stamp mirrors equal its host stamps."""
    import numpy as np

    from repro_torch.device import to_host
    for i, shard in enumerate(sg.shards):
        for f in ("created", "deleted"):
            got = to_host(getattr(shard, f"_d_{f}"))
            check(np.array_equal(got, getattr(shard, f)),
                  f"{what}: shard {i}'s device {f} mirror differs from its "
                  "host stamps")


def plane_queries(hot, epoch: int) -> list:
    """One epoch's 16 queries on the hottest vertices: 8 k-hop, 4
    reachability, 2 top-k and 2 PageRank top-8."""
    from repro_torch.graph.query import (DegreeTopK, KHop, PageRankQuery,
                                         Reachability)
    k = len(hot)
    qs = [KHop(int(hot[(epoch + i) % k]), k=1 + i % 2) for i in range(8)]
    qs += [Reachability(int(hot[i]), int(hot[(i + 5 + epoch) % k]),
                        max_hops=4) for i in range(4)]
    qs += [DegreeTopK(8), DegreeTopK(16), PageRankQuery(top_k=8),
           PageRankQuery(top_k=8)]
    return qs


def hottest(counts):
    """The PLANE_HOT vertices that received the most edges so far, ties
    to the lower id."""
    import numpy as np
    return np.argsort(-counts, kind="stable")[:PLANE_HOT]


def pagerank64(torch, view, init, iterations: int, damping: float = 0.85):
    """``iterations`` PageRank iterations of ``compute.pagerank`` from
    ``init`` (uniform when None) in float64, the join-group-by an
    ``index_add_`` in float64: the exact computation the float32 routes
    round."""
    n = view.n
    dev = view.out_degree.device
    out_deg = torch.clamp(view.out_degree.double(), min=1.0)
    dangling = view.out_degree == 0
    pr = (torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
          if init is None else torch.as_tensor(init, device=dev).double())
    src, dst = view.src.long(), view.dst.long()
    for _ in range(iterations):
        agg = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, dst, (pr / out_deg)[src])
        agg = agg + torch.where(dangling, pr, 0.0).sum() / n
        pr = (1.0 - damping) / n + damping * agg
    return pr


class bf16_contributions:
    """Within ``with``, ``compute.pagerank``'s join-group-by sums its
    contributions kept to bf16 (13a's PageRank control; the segment sum
    still adds in float32)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.graph import compute as gc
        self.gc, self.real = gc, gc.join_group_by

        def rounded(view, values, **kw):
            return self.real(view, values.to(self.torch.bfloat16).float(),
                             **kw)
        gc.join_group_by = rounded
        return self

    def __exit__(self, *exc):
        self.gc.join_group_by = self.real


def pagerank_errors(torch, runs) -> dict:
    """Each PageRank run ``runs`` recorded through the kernels against a
    float64 rerun from the same start for the same iterations
    (:func:`pagerank64`): the largest per-vertex |ranks - float64| /
    float64 over the runs (``kernel``, with the float64 rank where it is
    largest); the same for the run on the largest view made again with
    :class:`bf16_contributions` (``bf16_control``); and each version's
    kernel ranks (``by_version``)."""
    import numpy as np

    from repro_torch.device import to_host

    def worst(view, kw, res):
        exact = to_host(pagerank64(torch, view, kw.get("init"),
                                   res.iterations, kw.get("damping", 0.85)))
        err = np.abs(to_host(res.ranks).astype(np.float64) - exact) / exact
        i = int(err.argmax())
        return float(err[i]), float(exact[i])

    out = {"kernel": 0.0, "kernel_at_rank": None}
    by_version = {}
    for view, kw, res in runs.runs:
        err, rank = worst(view, kw, res)
        if err >= out["kernel"]:
            out["kernel"], out["kernel_at_rank"] = err, rank
        by_version.setdefault(view.version, []).append(to_host(res.ranks))
    view, kw, _ = max(runs.runs, key=lambda r: r[0].m)
    with bf16_contributions(torch):
        res = runs.real(view, **kw)
    out["bf16_control"], out["bf16_control_at_rank"] = worst(view, kw, res)
    out["bf16_control_iterations"] = res.iterations
    out["by_version"] = by_version
    return out


def serve_plane(torch, device: str, size: dict, wal_dir,
                fault=None) -> dict:
    """13a: the skewed stream through a ``GraphQueryServer`` over a
    planner-carrying, WAL-backed, fault-injected store on ``device``
    (auto-reshard and mirrors on), with a seal fault healed mid-stream and
    the newest split pair merged after the stream, held at every sealed
    version against two CPU oracles (a store fed the same batches with the
    same cutovers forced at the same activation epochs, under a server
    with ``replicate_hot=False``, and a single ``DynamicGraph``); every
    answer against the no-replica server's (computed on the CPU oracle
    store, whose view at that version is held equal to the single
    store's), or where that server is ahead (the degraded window) against
    its recomputation on the single store; each PageRank run made through
    the kernels run again from the same start in float64
    (:func:`pagerank_errors`, held by :func:`elastic_plane`).
    Launch counts are reset just before the serving loop and read just
    after it. ``fault`` plants one of :data:`PLANE_FAULTS` in the store
    under test (:class:`plane_taps`)."""
    import shutil

    import numpy as np

    from repro_torch.core.replica import ShardPlanner
    from repro_torch.device import to_host
    from repro_torch.graph.dyngraph import (DynamicGraph,
                                            synthesize_skewed_stream)
    from repro_torch.graph.query import PageRankQuery, SnapshotQueryEngine
    from repro_torch.graph.sharded import ShardedDynamicGraph
    from repro_torch.graph.wal import FaultInjector
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_graph import GraphQueryServer

    n, stream, adds = size["n"], size["stream"], size["adds"]
    epochs = stream + PLANE_AFTER_MERGE
    t = time.perf_counter()
    # the first `stream` batches are the planner's stream; the generator
    # draws epoch by epoch, so they equal a `stream`-epoch call's
    batches = synthesize_skewed_stream(
        n, epochs + PLANE_AFTER_RECOVERY, adds, seed=SEED, zipf_a=1.2,
        delete_frac=0.2)
    stream_s = time.perf_counter() - t
    total = sum(len(b.add_src) for b in batches)
    e_max = total + total // 2 + 16      # a merge re-adds a shard's rows
    inj = FaultInjector()
    sg = ShardedDynamicGraph(PLANE_SHARDS, n, e_max,
                             planner=ShardPlanner(**PLANE_PLANNER),
                             wal_dir=wal_dir,
                             checkpoint_every=PLANE_CKPT_EVERY,
                             fault_injector=inj, device=device)
    server = GraphQueryServer(sg, auto_reshard=True, mirror_k=PLANE_MIRROR_K,
                              prewarm_pagerank=True, tol=1e-6, max_iter=200)
    cpu_sg = ShardedDynamicGraph(PLANE_SHARDS, n, e_max, device="cpu")
    cpu_server = GraphQueryServer(cpu_sg, replicate_hot=False,
                                  auto_reshard=False, tol=1e-6,
                                  max_iter=200)
    single = DynamicGraph(n, total + 16, device="cpu")
    plain = SnapshotQueryEngine(result_cache=False, tol=1e-6, max_iter=200,
                                use_kernel=False)
    counts_in = np.zeros(n, np.int64)
    digests, events, step_s, window_s = {}, [], [], []
    answers = routed_compared = degraded_epochs = 0
    crash = None
    served_pr = []
    cutover_s = {}
    # host seconds of the loop outside the card server's steps and windows
    host_s = {"oracles": 0.0, "views held": 0.0, "answers held": 0.0}

    def timed(name):
        real = getattr(sg, name)

        def run(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            cutover_s[out["activation_epoch"]] = time.perf_counter() - t0
            return out
        return run
    sg.split_shard, sg.merge_shards = (timed("split_shard"),
                                       timed("merge_shards"))

    def window(e, qs, want_version, *, degraded=False):
        nonlocal answers, routed_compared
        for q in qs:
            server.submit(q)
        t0 = time.perf_counter()
        pairs = server.run_window()
        t1 = time.perf_counter()
        window_s.append(t1 - t0)
        check(len(pairs) == len(qs), f"epoch {e}: {len(pairs)} answers")
        others = [q for q in qs if not isinstance(q, PageRankQuery)]
        for q in others:
            cpu_server.submit(q)
        base = {id(req.query): resp for req, resp in cpu_server.run_window()}
        want = {}
        if any(base[id(q)].version != want_version for q in others):
            # the degraded window: the no-replica server is an epoch ahead
            view = single.join_view(want_version)
            want = dict(zip(map(id, others), plain.execute(view, others)))
        for req, resp in pairs:
            q = req.query
            check(resp.ok, f"epoch {e}: {q} failed: {resp.error}")
            check(resp.version == want_version,
                  f"epoch {e}: {q} answered at {resp.version}, expected "
                  f"{want_version}")
            check(resp.degraded == degraded,
                  f"epoch {e}: {q} degraded flag {resp.degraded}")
            if isinstance(q, PageRankQuery):
                served_pr.append((q, resp))
                continue
            b = base[id(q)]
            if b.version == resp.version:
                # a recomputation on the CPU oracle store, whose view at
                # this version hold_version has held equal to the single
                # store's
                check(same_answer(np, resp.value, b.value),
                      f"epoch {e}: {q} differs from the no-replica "
                      "server's answer")
                routed_compared += 1
            else:
                check(same_answer(np, resp.value, want[id(q)]),
                      f"epoch {e}: {q} differs from its recomputation on "
                      f"the single CPU store at {want_version}")
            answers += 1
        host_s["answers held"] += time.perf_counter() - t1

    def hold_version(e, v):
        t0 = time.perf_counter()
        d = view_digest(sg.join_view(v))
        c = view_digest(cpu_sg.join_view(v))
        s = view_digest(single.join_view(v))
        check(c == s, f"epoch {e}: the two CPU oracles differ at {v}")
        check(d == s, f"epoch {e}: the stitched view at {v} differs from "
                      "the CPU oracles")
        digests[v] = s
        host_s["views held"] += time.perf_counter() - t0

    caught_up = False
    ops.reset_launch_counts()
    t_loop = time.perf_counter()
    try:
        with counting_pagerank(record=True) as runs, \
                (plane_taps(fault, sg) if fault is not None
                 else contextlib.nullcontext()), \
                (primed_profile(torch) if device != "cpu"
                 else contextlib.nullcontext()) as profile:
            for e, b in enumerate(batches[:epochs]):
                if e == stream:
                    newest = [m for m in sg.migrations
                              if m["kind"] == "split"
                              and m["target"] not in sg.retired]
                    check(bool(newest), "the planner fired no split")
                    with server._ingest_lock:
                        merge = sg.merge_shards(newest[-1]["target"])
                    events.append(dict(merge))
                n_events = len(server.reshard_events)
                if e == size["fault_epoch"]:
                    inj.fail(0, e)
                t0 = time.perf_counter()
                server.step(b)
                sync(torch, device)
                step_s.append(time.perf_counter() - t0)
                events.extend(dict(ev) for ev in
                              server.reshard_events[n_events:])
                t0 = time.perf_counter()
                for ev in events:
                    if ev["activation_epoch"] == e:
                        cut = (cpu_sg.split_shard(ev["source"])
                               if ev["kind"] == "split" else
                               cpu_sg.merge_shards(ev["source"]))
                        check(all(cut[k] == ev[k] for k in cut),
                              f"epoch {e}: the CPU oracle's cutover {cut} "
                              f"differs from the card's {ev}")
                cpu_server.step(b)
                single.apply(b)
                counts_in += np.bincount(b.add_dst, minlength=n)
                host_s["oracles"] += time.perf_counter() - t0
                qs = plane_queries(hottest(counts_in), e)
                if e == size["fault_epoch"]:
                    st = server.stats()
                    check(st.degraded and st.seal_failures == 1
                          and st.stale_epochs == 1,
                          f"epoch {e}: the seal fault did not degrade the "
                          f"server: {st}")
                    degraded_epochs += 1
                    window(e, qs, batches[e - 1].version, degraded=True)
                    inj.heal()
                    caught_up = server.reseal() == e
                    check(caught_up, f"epoch {e}: the server did not catch "
                                     "up")
                    check(not server.stats().degraded,
                          f"epoch {e}: still degraded after the reseal")
                hold_version(e, b.version)
                window(e, qs, b.version)
                if e == stream and wal_dir is not None:
                    # a crash point past the merge's cutover: 13b recovers
                    # a copy of the log as it stood here (its checkpoint
                    # precedes the cutover, so the replay carries it)
                    sg.wal.sync()
                    for w in sg.wal_shards:
                        w.sync()
                    crash = {"dir": pathlib.Path(f"{wal_dir}_at_{e}"),
                             "epoch": e, "history": sg.plan.history,
                             "retired": set(sg.retired)}
                    shutil.copytree(wal_dir, crash["dir"])
            sync(torch, device)
        loop_s = time.perf_counter() - t_loop
        counts = ops.launch_counts()
        stats = server.stats()
    finally:
        server.stop_prewarm()
        cpu_server.stop_prewarm()
    splits = [ev for ev in events if ev["kind"] == "split"]
    merges = len(events) - len(splits)
    check(len(splits) >= 1, "the planner fired no split")
    check(merges == 1, f"{merges} merges, not the one asked for")
    if device != "cpu":
        check(counts["liveness_mask"] > 0, "no liveness_mask launch")
        check(counts["segment_sum"] == runs.iterations > 0,
              f"segment_sum launched {counts['segment_sum']} times in "
              f"{runs.iterations} PageRank iterations")
    pagerank = pagerank_errors(torch, runs)
    by_version = pagerank.pop("by_version")
    for q, resp in served_pr:
        tops = [(np.argsort(-full, kind="stable")[:q.top_k],
                 full[np.argsort(-full, kind="stable")[:q.top_k]])
                for full in by_version.get(resp.version, [])]
        check(any(same_answer(np, resp.value, s) for s in tops),
              f"{q} at {resp.version}: not the ranks of a kernel run")
    # every sealed version again, rebuilt from the stamps on the card
    t0 = time.perf_counter()
    for v, d in digests.items():
        check(view_digest(rebuilt_view(sg, v)) == d,
              f"the view at {v} rebuilt from the device stamps differs "
              "from the CPU oracles")
    rebuild_s = time.perf_counter() - t0
    check_stamp_mirrors(sg, "13a")
    busy = None
    if profile is not None:
        busy = busy_split(profile, sum(step_s) + sum(window_s))
        busy = {k: busy[k] for k in ("busy_share", "device_ms", "launches",
                                     "not_measured") if k in busy}
    for ev in events:
        ev["dispatch_s"] = cutover_s.get(ev["activation_epoch"])
        ev["step_s"] = step_s[ev["activation_epoch"]]
    return {"graph": sg, "batches": batches, "digests": digests,
            "epochs": epochs, "events": events, "splits": len(splits),
            "merges": merges, "step_s": step_s, "window_s": window_s,
            "stream_s": stream_s, "loop_s": loop_s, "host_s": host_s,
            "rebuild_s": rebuild_s,
            "counts": counts, "pagerank_iterations": runs.iterations,
            "pagerank_runs": len(runs.runs), "pagerank": pagerank,
            "answers_checked": answers, "routed_compared": routed_compared,
            "versions_checked": len(digests),
            "degraded_epochs": degraded_epochs, "caught_up": caught_up,
            "mirror_hit_rate": stats.mirror_hit_rate,
            "mirror_hits": stats.mirror_hits,
            "mirror_misses": stats.mirror_misses,
            "mean_fanout": stats.mean_fanout,
            "routed_windows": stats.routed_windows,
            "n_shards": sg.n_shards, "busy": busy, "crash": crash,
            "single": single, "planner_history": sg.plan.history}


def release_wal(sg) -> None:
    """Flush and close a store's write-ahead log (shard writers and the
    control log) and stop its apply pool."""
    if sg.wal is not None:
        for w in sg.wal_shards:
            if w is not None:
                w.close()
        sg.wal.close()
    sg.shutdown()


def hold_recovered(rec, ref, digests: dict, what: str,
                   versions=None) -> int:
    """A recovered store against the store that wrote its log: plan
    history, retired set, frontier, per-shard arrays, device stamp mirrors
    equal to its host stamps, and every view (rebuilt from the stamps) by
    digest. Returns the versions checked."""
    import numpy as np
    check(rec.plan.history == ref["history"],
          f"{what}: plan history {rec.plan.history} != {ref['history']}")
    check(rec.retired == ref["retired"], f"{what}: retired {rec.retired}")
    check(rec.coordinator.global_frontier == ref["frontier"],
          f"{what}: frontier {rec.coordinator.global_frontier} != "
          f"{ref['frontier']}")
    if "shards" in ref:
        check(len(rec.shards) == len(ref["shards"]),
              f"{what}: {len(rec.shards)} shards")
        for i, (s, want) in enumerate(zip(rec.shards, ref["shards"])):
            check(s.n_edges == want.n_edges, f"{what}: shard {i} rows")
            e = s.n_edges
            for f in ("src", "dst", "created", "deleted"):
                check(np.array_equal(getattr(s, f)[:e],
                                     getattr(want, f)[:e]),
                      f"{what}: shard {i} {f} differs")
    check_stamp_mirrors(rec, what)
    done = 0
    for v, d in digests.items():
        if versions is not None and v.epoch not in versions:
            continue
        check(view_digest(rebuilt_view(rec, v)) == d,
              f"{what}: the view at {v} differs")
        done += 1
    return done


def recover_plane(torch, device: str, a: dict, wal_dir, workdir) -> dict:
    """13b: ``ShardedDynamicGraph.recover`` of 13a's log onto ``device``
    and onto the CPU (from a copy), each held against 13a's store; a
    recovery of the crash point 13a copied past the merge's cutover (its
    replay carries the cutover); then ``PLANE_AFTER_RECOVERY`` more epochs
    into the recovered store on ``device``, held against the single CPU
    store."""
    import shutil

    from repro_torch.core.replica import ShardPlanner
    from repro_torch.graph.sharded import ShardedDynamicGraph

    sg = a["graph"]
    release_wal(sg)
    wal_bytes = sum(p.stat().st_size for p in pathlib.Path(wal_dir)
                    .rglob("*") if p.is_file())
    cpu_dir = pathlib.Path(workdir) / "wal_cpu"
    shutil.copytree(wal_dir, cpu_dir)
    ref = {"history": sg.plan.history, "retired": set(sg.retired),
           "frontier": sg.coordinator.global_frontier, "shards": sg.shards}
    t = time.perf_counter()
    rec = ShardedDynamicGraph.recover(
        wal_dir, planner=ShardPlanner(**PLANE_PLANNER), device=device)
    sync(torch, device)
    recover_s = time.perf_counter() - t
    t = time.perf_counter()
    checked = hold_recovered(rec, ref, a["digests"], f"13b on {device}")
    held_s = {"card": time.perf_counter() - t}
    t = time.perf_counter()
    rec_cpu = ShardedDynamicGraph.recover(
        cpu_dir, planner=ShardPlanner(**PLANE_PLANNER), device="cpu")
    recover_cpu_s = time.perf_counter() - t
    t = time.perf_counter()
    hold_recovered(rec_cpu, ref, a["digests"], "13b on the CPU")
    held_s["cpu"] = time.perf_counter() - t
    release_wal(rec_cpu)
    del rec_cpu
    crash = a["crash"]
    t = time.perf_counter()
    rec_crash = ShardedDynamicGraph.recover(crash["dir"], device=device)
    sync(torch, device)
    crash_s = time.perf_counter() - t
    crash_ref = {"history": crash["history"], "retired": crash["retired"],
                 "frontier": crash["epoch"]}
    t = time.perf_counter()
    crash_checked = hold_recovered(rec_crash, crash_ref, a["digests"],
                                   f"13b crash point on {device}",
                                   versions=range(crash["epoch"] + 1))
    held_s["crash point"] = time.perf_counter() - t
    release_wal(rec_crash)
    del rec_crash
    single = a["single"]
    more = a["batches"][a["epochs"]:]
    t = time.perf_counter()
    for b in more:
        rec.apply(b)
        single.apply(b)
        d = view_digest(single.join_view(b.version))
        check(view_digest(rec.join_view(b.version)) == d,
              f"13b: the recovered store's view at {b.version} differs "
              "from the single CPU store's")
        a["digests"][b.version] = d
    checked += len(more)
    check_stamp_mirrors(rec, "13b after more epochs")
    more_s = time.perf_counter() - t
    release_wal(rec)
    return {"recover_s": recover_s, "recover_cpu_s": recover_cpu_s,
            "crash_recover_s": crash_s, "crash_epoch": crash["epoch"],
            "crash_versions_checked": crash_checked,
            "versions_checked": checked, "wal_bytes": wal_bytes,
            "held_s": held_s, "more_epochs_s": more_s,
            "n_shards": len(rec.shards)}


def load_demo(stem: str):
    """``examples/<stem>.py`` as a module, registered under its stem: its
    dataclasses look themselves up, and the demos import one another by
    it."""
    import importlib.util
    if stem in sys.modules:
        return sys.modules[stem]
    path = ROOT / "examples" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[stem] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[stem]
        raise
    return mod


def plant_plane_faults(torch, device: str, workdir) -> dict:
    """Each of :data:`PLANE_FAULTS` planted in a 13a run (and a 13b
    recovery) at the small size must fail the check written for it."""
    import shutil

    from repro_torch.graph.sharded import ShardedDynamicGraph
    out = {}
    for i, fault in enumerate(PLANE_FAULTS[:2]):
        wal_dir = pathlib.Path(workdir) / f"planted_{i}"
        try:
            run = serve_plane(torch, device, PLANE_SMALL, wal_dir,
                              fault=fault)
            release_wal(run["graph"])
        except SmokeFailure as exc:
            want = (("differs from the CPU oracles",
                     "rebuilt from the device stamps") if i == 0
                    else ("no-replica server",))
            check(any(w in str(exc) for w in want),
                  f"planted {fault!r} failed another check: {exc}")
            out[fault] = "caught"
        else:
            raise SmokeFailure(f"planted {fault!r} was not caught")
    wal_dir = pathlib.Path(workdir) / "planted_2"
    run = serve_plane(torch, device, PLANE_SMALL, wal_dir)
    release_wal(run["graph"])
    crash = run["crash"]
    copy = pathlib.Path(workdir) / "planted_2_copy"
    shutil.copytree(crash["dir"], copy)
    ref = {"history": crash["history"], "retired": crash["retired"],
           "frontier": crash["epoch"]}
    hold_recovered(ShardedDynamicGraph.recover(crash["dir"], device=device),
                   ref, run["digests"], "sound recovery",
                   versions=range(crash["epoch"] + 1))
    try:
        with plane_taps(PLANE_FAULTS[2]):
            rec = ShardedDynamicGraph.recover(copy, device=device)
        hold_recovered(rec, ref, run["digests"], "planted recovery",
                       versions=range(crash["epoch"] + 1))
    except SmokeFailure as exc:
        check(any(w in str(exc) for w in ("plan history", "the view at")),
              f"planted {PLANE_FAULTS[2]!r} failed another check: {exc}")
        out[PLANE_FAULTS[2]] = "caught"
    else:
        raise SmokeFailure(f"planted {PLANE_FAULTS[2]!r} was not caught")
    return out


def elastic_plane(torch, device: str = "cuda", *, workdir,
                  small: bool = False, card: str = "") -> dict:
    """Phase 13: 13a :func:`serve_plane`, 13b :func:`recover_plane`, 13c
    the port's crash-recovery demo (``kill -9`` of a serving subprocess,
    recovery on ``device``, ``--recover``), and the planted faults, each
    part logged as it ends; 13a's PageRank limit is held last. At
    ``small`` size every part runs at :data:`PLANE_SMALL` (the CPU
    rehearsal)."""
    import dataclasses
    import shutil

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    size = PLANE_SMALL if small else PLANE_FULL
    out = {}
    try:
        t = time.perf_counter()
        a = serve_plane(torch, device, size, workdir / "wal")
        out["13a"] = {k: v for k, v in a.items()
                      if k not in ("graph", "batches", "digests", "single",
                                   "crash")}
        out["13a"]["s"] = time.perf_counter() - t
        log_13a(out["13a"], size, card)
        t = time.perf_counter()
        out["13b"] = recover_plane(torch, device, a, workdir / "wal",
                                   workdir)
        out["13b"]["s"] = time.perf_counter() - t
        log_13b(out["13b"], card)
        del a
        t = time.perf_counter()
        demo = load_demo("torch_crash_recovery_demo")
        run = demo.CrashRun(**(PLANE_CRASH_SMALL if small
                               else PLANE_CRASH), device=device)
        c = demo.run_demo(run, wal_dir=workdir / "crash")
        check(c["audited"] == c["frontier"] + 1
              and c["final_epoch"] == run.epochs - 1,
              f"13c: {c}")
        out["13c"] = {**c, "s": time.perf_counter() - t,
                      "run": dataclasses.asdict(run)}
        log_13c(out["13c"], card)
        t = time.perf_counter()
        out["planted"] = plant_plane_faults(torch, device,
                                            workdir / "planted")
        out["planted_s"] = time.perf_counter() - t
        log(f"phase 13 planted faults: {json.dumps(out['planted'])} "
            f"({out['planted_s']:.3f} s)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    pr = out["13a"]["pagerank"]
    check(pr["kernel"] <= PLANE_PAGERANK_RTOL,
          f"13a PageRank: kernel vs float64 {pr['kernel']} over "
          f"{PLANE_PAGERANK_RTOL}")
    check(pr["bf16_control"] > PLANE_PAGERANK_RTOL,
          f"13a PageRank: the bf16 control {pr['bf16_control']} within "
          f"{PLANE_PAGERANK_RTOL}")
    return out


def log_13a(a: dict, size: dict, card: str) -> None:
    log(f"phase 13a live resharding on {size['n']} vertices ({card}): "
        f"{a['epochs']} epochs of {size['adds']} adds (stream "
        f"{a['stream_s']:.3f} s), {a['splits']} planner splits and 1 merge, "
        f"{a['n_shards']} physical shards; step s "
        + " ".join(f"{x:.3f}" for x in a["step_s"])
        + "; window s " + " ".join(f"{x:.3f}" for x in a["window_s"])
        + f"; cutovers {json.dumps(a['events'])}; mirror hit rate "
        f"{a['mirror_hit_rate']:.4f} ({a['mirror_hits']} hits, "
        f"{a['mirror_misses']} misses), mean fan-out {a['mean_fanout']:.3f}"
        f" over {a['routed_windows']} routed windows; launches "
        f"{a['counts']} ({a['pagerank_iterations']} PageRank iterations in "
        f"{a['pagerank_runs']} runs; PageRank per-vertex relative error "
        f"against float64 {json.dumps(a['pagerank'])}, limit "
        f"{PLANE_PAGERANK_RTOL}); busy "
        f"{json.dumps(a['busy'])}; {a['versions_checked']} versions against "
        f"both CPU oracles, rebuilt from the stamps in "
        f"{a['rebuild_s']:.3f} s; {a['answers_checked']} answers "
        f"recomputed, {a['routed_compared']} against the no-replica server;"
        f" loop {a['loop_s']:.3f} s (host outside the card server "
        f"{json.dumps(a['host_s'])}), part {a['s']:.3f} s")


def log_13b(b: dict, card: str) -> None:
    log(f"phase 13b recovery ({card}): {b['wal_bytes']} WAL bytes; onto the"
        f" card {b['recover_s']:.3f} s, onto the CPU {b['recover_cpu_s']:.3f}"
        f" s; crash point at epoch {b['crash_epoch']} recovered in "
        f"{b['crash_recover_s']:.3f} s ({b['crash_versions_checked']} "
        f"versions); {b['versions_checked']} versions held (s "
        f"{json.dumps(b['held_s'])}); {PLANE_AFTER_RECOVERY} more epochs "
        f"ingested and held in "
        f"{b['more_epochs_s']:.3f} s; part "
        f"{b['s']:.3f} s")


def log_13c(c: dict, card: str) -> None:
    log(f"phase 13c kill -9 and --recover ({card}): {json.dumps(c['run'])};"
        f" killed serving epoch {c['seen']} after {c['kill_s']:.3f} s; "
        f"durable frontier {c['frontier']}, recovered in "
        f"{c['recover_s']:.3f} s, {c['audited']} epochs audited; resumed "
        f"{c['remaining']} epochs in {c['resume_s']:.3f} s, "
        f"{c['compared']} answers at epoch {c['final_epoch']} equal the "
        f"oracle's; {c['wal_bytes']} WAL bytes; part {c['s']:.3f} s")


# --------------------------------------------------------------- phase 14
def top10_swaps(np, top10, exact, rtol: float) -> list:
    """Each position where ``top10`` differs from the float64 ranks'
    ``exact`` top 10, as [its id, float64's id, their float64 ranks'
    relative gap]; a gap over ``rtol`` fails: only ranks that float32
    sums cannot tell apart may swap."""
    want = np.argsort(-exact, kind="stable")[:10]
    swaps = []
    for a, b in zip(top10, want.tolist(), strict=True):
        if a != b:
            swaps.append([int(a), int(b),
                          float(abs(exact[a] - exact[b]) / exact[b])])
    check(all(gap <= rtol for *_, gap in swaps),
          f"top-10 {list(top10)} against float64's {want.tolist()}: "
          f"swapped ranks {swaps} over {rtol}")
    return swaps


def demo_end_to_end(torch, device: str, small: bool = False) -> dict:
    """14a: ``examples/torch_dynamic_graph_end_to_end.py`` (``run_demo``)
    on ``device`` at DEMO_GRAPH's store (DEMO_SMALL when ``small``),
    launch counts reset just before and read just after (``liveness_mask``
    launched, ``segment_sum`` once per PageRank iteration), then again on
    the CPU path: every fact of E2E_FACTS equal. Each PageRank run is held
    per vertex against a float64 rerun (:func:`pagerank_errors`), and the
    lineage's top-10 against the float64 ranks' (:func:`top10_swaps`)."""
    import dataclasses

    import numpy as np

    from repro_torch.device import to_host
    from repro_torch.kernels import ops

    demo = load_demo("torch_dynamic_graph_end_to_end")
    size = demo.Size(**(DEMO_SMALL if small else DEMO_GRAPH),
                     epochs=DEMO_E2E_EPOCHS)
    ops.reset_launch_counts()
    t = time.perf_counter()
    with counting_pagerank(record=True) as runs:
        facts = demo.run_demo(size, device)
        sync(torch, device)
    run_s = time.perf_counter() - t
    counts = ops.launch_counts()
    if device == "cuda":
        check(counts["liveness_mask"] > 0, "14a: no liveness_mask launch")
        check(counts["segment_sum"] == runs.iterations > 0,
              f"14a: segment_sum launched {counts['segment_sum']} times in "
              f"{runs.iterations} PageRank iterations")
    t = time.perf_counter()
    cpu = demo.run_demo(size, "cpu")
    cpu_s = time.perf_counter() - t
    differ = {k: [facts[k], cpu[k]] for k in E2E_FACTS if facts[k] != cpu[k]}
    check(not differ, f"14a: facts differ from the CPU path's: {differ}")
    pr = pagerank_errors(torch, runs)
    del pr["by_version"]
    view, kw, res = runs.runs[-1]         # the lineage's recovery
    exact = to_host(pagerank64(torch, view, kw.get("init"), res.iterations,
                               kw.get("damping", 0.85)))
    swaps = top10_swaps(np, facts["top10"], exact, PLANE_PAGERANK_RTOL)
    check(pr["kernel"] <= PLANE_PAGERANK_RTOL,
          f"14a PageRank: kernel vs float64 {pr['kernel']} over "
          f"{PLANE_PAGERANK_RTOL}")
    check(pr["bf16_control"] > PLANE_PAGERANK_RTOL,
          f"14a PageRank: the bf16 control {pr['bf16_control']} within "
          f"{PLANE_PAGERANK_RTOL}")
    return {"size": dataclasses.asdict(size),
            "facts": {k: facts[k] for k in E2E_FACTS},
            "timeline_iterations": facts["timeline_iterations"],
            "cold_iterations": facts["cold_iterations"],
            "cpu_timeline_iterations": cpu["timeline_iterations"],
            "top10": facts["top10"], "top10_swaps": swaps,
            "ranks_device": facts["ranks_device"], "counts": counts,
            "pagerank_runs": len(runs.runs),
            "pagerank_iterations": runs.iterations, "pagerank": pr,
            "run_s": run_s, "cpu_s": cpu_s}


def demo_live(torch, device: str, small: bool = False) -> dict:
    """14b: ``examples/torch_serve_graph_live.py`` (``run_demo``: a
    background ingest thread, the server's prewarm thread and the querying
    thread on one device) at DEMO_GRAPH's store over DEMO_LIVE_EPOCHS
    unpaced epochs, launch counts reset just before and read just after.
    The demo's own audit holds every k-hop, reachability and top-k answer
    against a single-store replay on the CPU at its version; each
    PageRank run (the prewarms' and the windows') is held per vertex
    against a float64 rerun (:func:`pagerank_errors`)."""
    from repro_torch.kernels import ops

    demo = load_demo("torch_serve_graph_live")
    run = demo.LiveRun(**(DEMO_SMALL if small else DEMO_GRAPH),
                       epochs=DEMO_LIVE_EPOCHS, delay_s=0.0)
    ops.reset_launch_counts()
    t = time.perf_counter()
    with counting_pagerank(record=True) as runs:
        facts = demo.run_demo(run, device)
        sync(torch, device)
    run_s = time.perf_counter() - t
    counts = ops.launch_counts()
    if device == "cuda":
        check(counts["liveness_mask"] > 0, "14b: no liveness_mask launch")
        check(counts["segment_sum"] == runs.iterations > 0,
              f"14b: segment_sum launched {counts['segment_sum']} times in "
              f"{runs.iterations} PageRank iterations")
    check(all(facts["audited"].get(k, 0) > 0 for k in QUERY_KINDS),
          f"14b: audited {facts['audited']}")
    # unpaced, the stream may drain before a window reads its last epoch
    check(facts["versions"] > 1 and facts["prewarm_runs"] > 0,
          f"14b: answers at {facts['versions']} versions, "
          f"{facts['prewarm_runs']} prewarms")
    pr = pagerank_errors(torch, runs)
    del pr["by_version"]
    check(pr["kernel"] <= PLANE_PAGERANK_RTOL,
          f"14b PageRank: kernel vs float64 {pr['kernel']} over "
          f"{PLANE_PAGERANK_RTOL}")
    check(pr["bf16_control"] > PLANE_PAGERANK_RTOL,
          f"14b PageRank: the bf16 control {pr['bf16_control']} within "
          f"{PLANE_PAGERANK_RTOL}")
    keep = ("served", "windows", "wall_s", "audited", "audit_s", "versions",
            "final_epoch", "p50_ms", "p95_ms", "vectorized_calls",
            "rank_warm_starts", "rank_cold_starts", "rank_cache_hits",
            "prewarm_runs")
    return {**{k: facts[k] for k in keep}, "counts": counts,
            "pagerank_runs": len(runs.runs),
            "pagerank_iterations": runs.iterations, "pagerank": pr,
            "run_s": run_s}


def demo_rpc(device: str) -> dict:
    """14c: ``examples/torch_rpc_quickstart.py`` (``run_demo``) at its own
    sizes: the port's ``serve_graph`` on ``device`` as a subprocess, 4
    socket clients, every pinned replay byte-identical, every answer equal
    to a single-store replay on the CPU."""
    demo = load_demo("torch_rpc_quickstart")
    run = demo.RpcRun()
    t = time.perf_counter()
    facts = demo.run_demo(run, device)
    check(all(facts["audited"].get(k, 0) > 0 for k in QUERY_KINDS)
          and facts["pinned"] > 0 and facts["returncode"] == 0,
          f"14c: audited {facts['audited']}, {facts['pinned']} pinned, "
          f"server exit {facts['returncode']}")
    return {**{k: facts[k] for k in ("served", "windows", "audited",
                                      "pinned", "shed_overload",
                                      "shed_deadline")},
            "serving": str(facts["serving"]), "s": time.perf_counter() - t}


def demo_batched(torch, device: str) -> dict:
    """14d, after the default model at full width: the other three models
    of ``examples/torch_serve_batched.py`` (``run_demo``) at its sizes,
    launch counts reset just before and read just after (one
    ``flash_attention`` per attention layer and one ``lru_scan`` per
    RG-LRU layer, in the prefills; reduced heads of 16 take the ``simt``
    route); then each model's prefill through the kernels against the
    plain versions within MODEL_RTOL (:func:`check_model_against_plain`)."""
    import numpy as np

    from repro_torch.configs import ATTN_KINDS
    from repro_torch.kernels import ops

    demo = load_demo("torch_serve_batched")
    b = demo.Batch()
    archs = tuple(a for a in demo.ARCHS if a != DEFAULT_ARCH)
    ops.reset_launch_counts()
    t = time.perf_counter()
    served = demo.run_demo(b, device, archs=archs)
    sync(torch, device)
    run_s = time.perf_counter() - t
    counts = ops.launch_counts()
    routes = ops.route_counts()["flash_attention"]
    kinds = [k for f in served.values() for _, k in f["model"].blocks()]
    want = {"flash_attention": sum(k in ATTN_KINDS for k in kinds),
            "lru_scan": kinds.count("rglru")}
    if device == "cuda":
        check(all(counts[k] == n for k, n in want.items())
              and routes["simt"] == want["flash_attention"],
              f"14d: launches {counts}, routes {routes}, expected {want}")
    out = {"counts": {k: counts[k] for k in want}, "routes": routes,
           "run_s": run_s, "models": {}}
    for arch, f in served.items():
        tokens = f["tokens"]
        check(tokens.shape == (b.requests, b.gen) and tokens.dtype == np.int32
              and bool(((tokens >= 0) & (tokens < f["cfg"].vocab_size))
                       .all()),
              f"14d {arch}: tokens of shape {tokens.shape}")
        agree = check_model_against_plain(
            torch, {"cfg": f["cfg"], "model": f["model"],
                    "prompts": demo.prompts_for(f["cfg"], b)}, gen=b.gen)
        out["models"][arch] = {
            "s": f["s"], "tokens_per_s": f["tokens_per_s"],
            "prefill_s": f["prefill_s"], "decode_s": f["decode_s"],
            "sample": tokens[0][:4].tolist(),
            "prefill_rel_err": agree["worst_rel_err"]}
    return out


def demo_training(torch, device: str) -> dict:
    """14e: ``examples/torch_quickstart.py`` and
    ``examples/torch_elastic_restart.py`` (``run_demo``) at their sizes,
    launch counts reset just before each and read just after (on the card
    the attention backward must have run). The first loss within
    FIRST_LOSS_TOL of ln(vocab) and the last five steps' mean under the
    first five's; the served tokens in range; the restart restored at the
    newest checkpoint's step, and its first resumed loss (the restored
    weights on the same batch) equal to the uninterrupted run's at that
    index. On the card, then, ``flash_attention`` and
    ``flash_attention_bwd`` against their plain versions at each demo's
    training shape (:func:`demo_attention_cases`)."""
    import math

    import numpy as np

    from repro_torch.kernels import ops

    q_demo = load_demo("torch_quickstart")
    e_demo = load_demo("torch_elastic_restart")
    q = q_demo.Quick()
    ops.reset_launch_counts()
    t = time.perf_counter()
    fq = q_demo.run_demo(q, device)
    sync(torch, device)
    q_s = time.perf_counter() - t
    q_counts = ops.launch_counts()
    e = e_demo.Elastic()
    ops.reset_launch_counts()
    t = time.perf_counter()
    fe = e_demo.run_demo(e, device)
    sync(torch, device)
    e_s = time.perf_counter() - t
    e_counts = ops.launch_counts()
    if device == "cuda":
        for name, c in (("quickstart", q_counts), ("elastic", e_counts)):
            check(c["flash_attention"] > 0 and c["flash_attention_bwd"] > 0,
                  f"14e {name}: launches {c}")
    for name, f, cfg in (("quickstart", fq, q_demo.config()),
                         ("elastic", fe, e_demo.config())):
        losses = f["losses"]
        check(all(math.isfinite(x) for x in losses + f.get("resumed", []))
              and abs(losses[0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_TOL
              and np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"14e {name}: losses {losses}")
    gen = fq["generated"]
    check(gen.shape == (q.prompts, q.gen) and bool(
        ((gen >= 0) & (gen < q_demo.config().vocab_size)).all()),
        f"14e quickstart: generated {gen}")
    newest = (e.steps - 1) // e.ckpt_every * e.ckpt_every + 1
    check(fe["restored"] == newest and fe["final_step"] == newest + e.resume,
          f"14e elastic: restored at {fe['restored']} (newest checkpoint "
          f"{newest}), final step {fe['final_step']}")
    check(fe["resumed"][0] == fe["losses"][newest],
          f"14e elastic: resumed loss {fe['resumed'][0]} at batch {newest}, "
          f"the uninterrupted run's {fe['losses'][newest]}")
    held = {} if device != "cuda" else {
        "quickstart": demo_attention_cases(torch, q_demo.config(), q),
        "elastic": demo_attention_cases(torch, e_demo.config(), e)}
    return {"held": held,
            "quickstart": {"losses_head_tail": [fq["losses"][:3],
                                                fq["losses"][-3:]],
                           "first": fq["first"], "last": fq["last"],
                           "generated": gen[0].tolist(),
                           "counts": {k: v for k, v in q_counts.items() if v},
                           "s": q_s},
            "elastic": {"losses_head_tail": [fe["losses"][:3],
                                             fe["losses"][-3:]],
                        "restored": fe["restored"], "mesh": fe["mesh"],
                        "mesh_device": fe["mesh_device"],
                        "resumed": fe["resumed"],
                        "final_step": fe["final_step"],
                        "counts": {k: v for k, v in e_counts.items() if v},
                        "s": e_s}}


def demo_attention_cases(torch, cfg, run) -> list[dict]:
    """``flash_attention`` (within 1e-2, as the bf16 cases of phase 2)
    and ``flash_attention_bwd`` (within BWD_RTOL_BF16, its planted faults
    over it) against their plain versions in ``cfg.dtype``, at every
    attention shape a training step of ``run.batch`` x ``run.seq`` gives
    (:func:`family_attention_shapes`), on fresh random inputs. Returns
    each shape's errors and times."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    dtype = getattr(torch, cfg.dtype)
    out = []
    for B, Hq, Hkv, S, hd, window in family_attention_shapes(
            cfg, run.batch, prompt=run.seq):
        shape = (B, Hq, Hkv, S, hd)
        fwd = flash_attention_case(torch, g, shape, dtype, window, 1e-2)
        bwd = flash_attention_bwd_case(torch, g, shape, dtype, window,
                                       BWD_RTOL_BF16)
        out.append({"shape": fwd["shape"], "route": fwd["kernel_route"],
                    "fwd_max_abs_err": fwd["max_abs_err"],
                    "bwd_rel_err": bwd["max_abs_err"],
                    "bwd_planted": bwd["planted"], "fwd_ms": fwd["ms"],
                    "bwd_ms": bwd["ms"]})
    return out


def run_demos(torch, rows, card: str, device: str = "cuda",
              small: bool = False) -> dict:
    """Phase 14, each part logged as it ends: 14a :func:`demo_end_to_end`,
    14b :func:`demo_live`, 14c :func:`demo_rpc`, 14d the default model at
    full width (:func:`serve_families` on its FAMILY_RUNS entry, its
    ``flash_attention`` row appended to ``rows``) then
    :func:`demo_batched`, 14e :func:`demo_training`. ``small`` (the CPU
    rehearsal) runs 14a and 14b at DEMO_SMALL and leaves out the
    full-width model."""
    out = {}
    t = time.perf_counter()
    a = out["14a"] = demo_end_to_end(torch, device, small)
    log(f"phase 14a end-to-end demo on {json.dumps(a['size'])} ({card}): "
        f"facts equal to the CPU path's {json.dumps(a['facts'])}; PageRank "
        f"iterations per version {a['timeline_iterations']} (cold "
        f"{a['cold_iterations']}; the CPU path's "
        f"{a['cpu_timeline_iterations']}), {a['pagerank_runs']} runs, "
        f"{a['pagerank_iterations']} iterations, per-vertex relative error "
        f"against float64 {json.dumps(a['pagerank'])} (limit "
        f"{PLANE_PAGERANK_RTOL}); top-10 {a['top10']} on "
        f"{a['ranks_device']}, swaps against float64 {a['top10_swaps']}; "
        f"launches {a['counts']}; run {a['run_s']:.3f} s, CPU path "
        f"{a['cpu_s']:.3f} s; part {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    b = out["14b"] = demo_live(torch, device, small)
    log(f"phase 14b live demo ({card}): {json.dumps(b)}; part "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    c = out["14c"] = demo_rpc(device)
    log(f"phase 14c RPC quickstart subprocess ({card}): {json.dumps(c)}")
    if not small:
        t = time.perf_counter()
        serve_families(torch, rows, runs=FAMILY_RUNS[-1:], train=False)
        log(f"phase 14d {DEFAULT_ARCH} at full width: "
            f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    d = out["14d"] = demo_batched(torch, device)
    log(f"phase 14d batched serving demo ({card}): {json.dumps(d)}; part "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    e = out["14e"] = demo_training(torch, device)
    log(f"phase 14e quickstart and elastic restart demos ({card}): "
        f"{json.dumps(e)}; part {time.perf_counter() - t:.3f} s")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
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
    da_row, da_extra = check_decode_attention(torch)
    log(f"phase 2 decode_attention vs plain, relative to the largest "
        f"output (limits {DECODE_RTOL}): worst "
        f"{max(da_row['errors'].values()):.3e} over "
        f"{len(da_row['errors'])} cases; planted faults "
        f"{json.dumps(da_row['planted'])}")
    rows.append(da_row)
    extra.extend(da_extra)
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
    # phase 12 holds the dry-run's prediction against these
    measured = {"prefill": {
        "peak_bytes": model_run["peak_gib"] * 2**30,
        "left_bytes": model_run["base_bytes"] - model_run["weight_bytes"],
        "s": tm["prefill_s"]}}
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
    wcc = check_wcc_kernel(torch, view)
    log(f"phase 6 WCC kernel route vs plain route, bit-equal labels at "
        f"every cap (launches against the plain rounds, seconds): "
        f"{json.dumps(wcc['compared'])}; planted faults caught: "
        f"{json.dumps(wcc['planted'])}")
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
    measured["train"] = {"peak_bytes": train_run["peak_gib"] * 2**30,
                         "left_bytes": train_run["base_bytes"],
                         "s": train_run["step_s"]}
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
        row["launches"] = (model_counts if name in (
            "lru_scan", "flash_attention", "decode_attention")
                           else counts)[name]
        if name in ("lru_scan", "flash_attention"):
            # the training path's launches of the same kernel (phase 8c)
            row["launches_training"] = train_counts[name]

    t = time.perf_counter()
    serve_families(torch, rows)
    log(f"phase 9 the dense-attention and frames families: "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    serve_moe_family(torch, rows)
    log(f"phase 10 the MoE family: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    log_xlstm(serve_xlstm_family(torch), card)
    log(f"phase 11 the xLSTM family: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    elastic = elastic_continuation(torch)
    torch.cuda.empty_cache()
    log_phase12(elastic, predict_against_card(torch, measured), card)
    log(f"phase 12 elastic restart and the dry-run against the card: "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    plane = elastic_plane(torch, workdir=ROOT / "build" / "phase13",
                          card=card)
    log(f"phase 13 the elastic and durable graph plane: "
        f"{time.perf_counter() - t:.3f} s")
    for row in rows:
        if row["name"] in plane["13a"]["counts"]:
            # the elastic plane's serving loop (phase 13a)
            row["launches_phase13"] = plane["13a"]["counts"][row["name"]]
    t = time.perf_counter()
    demos = run_demos(torch, rows, card)
    log(f"phase 14 the reference's examples as the port's entry points: "
        f"{time.perf_counter() - t:.3f} s")
    for row in rows:
        for part in ("14a", "14b"):
            if row["name"] in demos[part]["counts"]:
                # the end-to-end and live demos' runs (phase 14a, 14b)
                row[f"launches_phase{part}"] = \
                    demos[part]["counts"][row["name"]]
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
