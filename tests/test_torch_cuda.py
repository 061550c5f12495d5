"""The port's CUDA kernels and its serving path on a card, against the
plain versions. Marked ``cuda``: every test skips without a CUDA device.
Imports no JAX, so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.versioned import PACK32_NEVER  # noqa: E402
from repro_torch.graph.dyngraph import synthesize_churn_stream  # noqa: E402
from repro_torch.graph.sharded import ShardedDynamicGraph  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(0)
    n = 100_003                      # not a multiple of 4: the scalar tail
    created = torch.from_numpy(
        (rng.integers(0, 8, n) << 20).astype(np.int32)).to(cuda_device)
    deleted = created + (1 << 20)
    deleted[torch.from_numpy(rng.random(n) < 0.5).to(cuda_device)] = \
        PACK32_NEVER
    for q in (0, 3 << 20, PACK32_NEVER - 1):
        for c, d in ((created, deleted), (created[1:], deleted[1:])):
            assert torch.equal(ops.liveness_mask(c, d, q, use_kernel=True),
                               ref.liveness_mask(c, d, q))
    versions = torch.sort(torch.from_numpy(
        rng.integers(0, 64, (5000, 4)).astype(np.int32)), dim=1).values
    versions = versions.to(cuda_device)
    for dtype in (torch.float32, torch.int32):
        values = torch.from_numpy(rng.integers(-9, 9, (5000, 4))).to(
            cuda_device, dtype)
        got = ops.snapshot_resolve(versions, values, 31, use_kernel=True)
        want = ref.snapshot_resolve(versions, values, 31)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for m, segs, f, dtype in ((5000, 100, 1, torch.float32),
                              (5000, 100, 16, torch.bfloat16),
                              (5000, 7, 5, torch.float32),
                              (0, 10, 1, torch.float32)):
        ids = torch.from_numpy(np.sort(rng.integers(0, segs + 1, m))
                               .astype(np.int32)).to(cuda_device)
        vals = torch.from_numpy(rng.standard_normal((m, f)).astype(
            np.float32)).to(cuda_device, dtype)
        # both float32 sums against the exact one: a segment of the third
        # case holds about 700 rows, whose running sum rounds at up to 2^-24
        # of the absolute mass per add, so a fixed 1e-5 is below the plain
        # version's own rounding there
        keep = ids < segs
        exact, mass = (torch.zeros((segs, f), dtype=torch.float64,
                                   device=cuda_device)
                       .index_add_(0, ids[keep].long(), x[keep].double())
                       for x in (vals, vals.abs()))
        limit = 1e-5 + 8 * 2.0 ** -24 * mass
        for got in (ops.segment_sum(vals, ids, segs, use_kernel=True),
                    ref.segment_sum(vals, ids, segs)):
            assert got.dtype == torch.float32 and got.shape == (segs, f)
            assert bool(((got.double() - exact).abs() <= limit).all())


def test_sharded_views_on_card_equal_cpu(cuda_device):
    batches = synthesize_churn_stream(300, 4, 400, seed=2, delete_frac=0.3)
    e_max = sum(len(b.add_src) for b in batches) + 16
    card = ShardedDynamicGraph(3, 300, e_max, device=cuda_device)
    host = ShardedDynamicGraph(3, 300, e_max, device="cpu")
    before = ops.launch_counts()["liveness_mask"]
    for b in batches:
        card.apply(b)
        host.apply(b)
        a, w = card.join_view(b.version), host.join_view(b.version)
        for f in ("offsets", "src", "dst", "out_degree", "in_degree"):
            assert torch.equal(getattr(a, f).cpu(), getattr(w, f)), f
    assert ops.launch_counts()["liveness_mask"] > before


def _lru_scan_shapes():
    """Odd shapes, and S at the edges of the forward's segment of W warps
    x T steps at C = 40 (not a multiple of the 32-channel tile)."""
    from repro_torch.kernels import lru_scan as lru
    W, T = lru.SCAN_WARPS, lru.SCAN_STEPS
    edges = (1, T - 1, T, T + 1, W * T - 1, W * T, W * T + 1, 3 * W * T + 5)
    return ((1, 1, 1), (2, 37, 40), (3, 100, 64), (1, 513, 96),
            *((2, S, 40) for S in edges))


def test_lru_scan_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    for B, S, C in _lru_scan_shapes():
        a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, C))
                             .astype(np.float32)).to(cuda_device)
        b = torch.from_numpy(rng.standard_normal((B, S, C))
                             .astype(np.float32)).to(cuda_device)
        h0 = torch.from_numpy(rng.standard_normal((B, C))
                              .astype(np.float32)).to(cuda_device)
        for init in (None, h0):
            torch.testing.assert_close(
                ops.lru_scan(a, b, init, use_kernel=True),
                ref.lru_scan(a, b, init), atol=1e-5, rtol=1e-4)


def test_lru_scan_kernel_gives_the_same_bits_twice(cuda_device):
    """The warps' aggregates are folded in a fixed order and nothing
    crosses between blocks: two calls agree bit for bit."""
    rng = np.random.default_rng(3)
    for B, S, C in ((2, 4099, 2600), *_lru_scan_shapes()):
        a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, C))
                             .astype(np.float32)).to(cuda_device)
        b = torch.from_numpy(rng.standard_normal((B, S, C))
                             .astype(np.float32)).to(cuda_device)
        h0 = torch.from_numpy(rng.standard_normal((B, C))
                              .astype(np.float32)).to(cuda_device)
        for init in (None, h0):
            assert torch.equal(ops.lru_scan(a, b, init, use_kernel=True),
                               ops.lru_scan(a, b, init, use_kernel=True))


def test_flash_attention_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    cases = ((1, 2, 2, 64, 16, None, torch.float32),
             (2, 4, 2, 100, 64, None, torch.float32),    # ragged S
             (1, 4, 1, 200, 32, 48, torch.float32),      # window, MQA
             (1, 2, 1, 130, 128, 64, torch.bfloat16),
             (1, 2, 1, 192, 256, 64, torch.bfloat16))
    for B, Hq, Hkv, S, hd, window, dtype in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda_device, dtype)
                   for s in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
        tol = 2e-4 if dtype == torch.float32 else 3e-2
        for causal in (True, False):
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      use_kernel=True)
            assert got.dtype == dtype
            torch.testing.assert_close(
                got.float(), ref.flash_attention(q, k, v, causal=causal,
                                                 window=window).float(),
                atol=tol, rtol=tol)


def test_reduced_model_kernel_prefill_matches_plain(cuda_device):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as tf

    cfg = reduced(get_config("recurrentgemma-2b"), num_layers=5)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    model = tf.init_params(cfg, gen, cuda_device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(cuda_device)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got, _ = tf.prefill(model, cfg, prompts)
    counts = ops.launch_counts()
    assert (counts["lru_scan"], counts["flash_attention"]) == (4, 1)
    with torch.inference_mode():
        want, _ = tf.prefill(model, cfg, prompts, use_kernel=False)
    # bf16 activations: the two routes round at other places
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    out = Server(cfg, model).generate(prompts.cpu().numpy(), 4)
    assert out.shape == (2, 4) and ((out >= 0) & (out < cfg.vocab_size)).all()


def test_flash_attention_routes_match_plain(cuda_device):
    """The bf16 edge cases chip_smoke.py holds at 1e-2, on the tensor-core
    route: ragged S with a window off the tile grid and GQA 4, and S one
    row past a tile; plus a float32 case on the CUDA-core route."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(5)
    cases = ((1, 8, 2, 1000, 128, 300, torch.bfloat16, 1e-2),
             (2, 4, 4, 4097, 64, None, torch.bfloat16, 1e-2),
             (1, 2, 1, 300, 256, 100, torch.bfloat16, 1e-2),
             (1, 4, 2, 300, 64, 100, torch.float32, 2e-4))
    for B, Hq, Hkv, S, hd, window, dtype, tol in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda_device, dtype)
                   for s in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, window=window, use_kernel=True)
        routes = ops.route_counts()["flash_attention"]
        assert routes[fa.route(dtype, hd)] == 1 and sum(routes.values()) == 1
        torch.testing.assert_close(
            got.float(), ref.flash_attention(q, k, v, window=window).float(),
            atol=tol, rtol=tol)


def test_segment_sum_edge_cases_match_exact(cuda_device):
    """The one-pass kernel on hub segments over three 2,048-row chunks,
    empty segments at the head, middle and tail, phantom rows, m not a
    multiple of 4 and F > 1, with ids and values aligned and one row off
    their allocations, against the float64 sum (limit as above)."""
    rng = np.random.default_rng(6)
    n = 500
    ids = np.concatenate([np.full(3, 4), np.full(7_000, 5),
                          np.repeat(np.arange(6, 200), 3), np.full(6_500, 210),
                          np.arange(220, 400, 3), np.full(9, n)]).astype(np.int32)
    assert len(ids) % 4
    for f in (1, 3):
        ids_t = torch.from_numpy(ids).to(cuda_device)
        vals = torch.from_numpy(rng.standard_normal((len(ids), f))
                                .astype(np.float32)).to(cuda_device)
        keep = ids_t < n
        exact, mass = (torch.zeros((n, f), dtype=torch.float64,
                                   device=cuda_device)
                       .index_add_(0, ids_t[keep].long(), x[keep].double())
                       for x in (vals, vals.abs()))
        limit = 1e-5 + 8 * 2.0 ** -24 * mass
        for i, x in ((ids_t, vals), (torch.cat([ids_t[:1], ids_t])[1:],
                                     torch.cat([vals[:1], vals])[1:])):
            ops.reset_launch_counts()
            got = ops.segment_sum(x, i, n, use_kernel=True)
            assert ops.launch_counts()["segment_sum"] == 1
            assert bool(((got.double() - exact).abs() <= limit).all())


def _partition_bound(view, values, n_parts):
    """Two float32 sums of the same d terms plus n_parts partials differ
    by at most 2 (d + n_parts) 2^-24 times the terms' absolute mass."""
    src, dst = view.src.cpu().long(), view.dst.cpu().long()
    mass = torch.zeros(view.n, dtype=torch.float64).index_add_(
        0, dst, values.double().abs()[src])
    deg = torch.bincount(dst, minlength=view.n).double()
    return 2 * (deg + n_parts) * 2.0 ** -24 * mass


def test_partition_modes_on_card_equal_cpu(cuda_device):
    from repro_torch.core.versioned import Version
    from repro_torch.graph import partition as gp
    from repro_torch.graph.dyngraph import synthesize_stream

    views = [synthesize_stream(2000, 4, 3000, seed=3, device=d)[0]
             .join_view(Version(3, 0)) for d in (cuda_device, "cpu")]
    pgs = [gp.partition_graph(v, 8, hub_k=16) for v in views]
    for f in ("src", "dst", "mask", "out_degree", "hubs", "is_hub"):
        assert torch.equal(getattr(pgs[0], f).cpu(), getattr(pgs[1], f)), f
    values = torch.from_numpy(
        np.random.default_rng(5).random(pgs[1].n).astype(np.float32))
    limit = _partition_bound(views[1], values, 8)
    for mode in ("allgather", "scatter", "hub"):
        card = gp.distributed_join_group_by(pgs[0], values.to(cuda_device),
                                            mode=mode)
        host = gp.distributed_join_group_by(pgs[1], values, mode=mode)
        assert card.device.type == "cuda" and card.dtype == torch.float32
        err = (card.cpu().double() - host.double()).abs()[:views[1].n]
        assert bool((err <= limit).all()), mode


def test_offline_timeline_on_card_equals_cpu(cuda_device):
    from repro_torch.core.versioned import Version
    from repro_torch.graph import compute as gc
    from repro_torch.graph.dyngraph import synthesize_stream

    versions = [Version(e, 0) for e in range(5)]
    runs = {}
    for d in (cuda_device, "cpu"):
        g, _ = synthesize_stream(3000, 5, 4000, seed=4, device=d)
        ops.reset_launch_counts()
        res = gc.pagerank_timeline(g, versions, incremental=True, tol=1e-6,
                                   max_iter=200)
        counts = ops.launch_counts()
        last = g.join_view(versions[-1])
        runs[str(d)] = (res, counts, gc.wcc(last).cpu(),
                        gc.emerging_vertices(g, versions[1], versions[-1]))
    (card, counts, labels, top), (host, _, host_labels, host_top) = \
        runs["cuda"], runs["cpu"]
    assert counts["segment_sum"] == sum(r.iterations for r in card) > 0
    assert counts["liveness_mask"] > 0
    for a, b in zip(card, host):
        assert abs(a.iterations - b.iterations) <= 1
        np.testing.assert_allclose(a.ranks.cpu().numpy(), b.ranks.numpy(),
                                   rtol=0, atol=1e-6)
    assert torch.equal(labels, host_labels)
    assert np.array_equal(top, host_top)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        / max(float(want.float().abs().max()), 1e-30)


def test_backward_kernels_match_plain(cuda_device):
    """flash_attention_bwd and lru_scan_bwd against their plain versions,
    fed the same forward output (and lse): relative to each gradient's
    largest magnitude, 1e-2 in bf16 (one rounding of the output), 1e-4 in
    float32, 1e-5 for the scan."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as lru

    rng = np.random.default_rng(5)
    for B, Hq, Hkv, S, hd, window, dtype in (
            (1, 2, 2, 64, 16, None, torch.float32),
            (2, 4, 2, 100, 64, 30, torch.float32),
            (1, 4, 1, 200, 32, 48, torch.bfloat16),
            (1, 2, 1, 130, 128, None, torch.bfloat16),
            (1, 10, 1, 192, 256, 64, torch.bfloat16)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda_device, dtype) for s in (
            (B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
            (B, Hq, S, hd)))
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        out, lse = fa.flash_attention(q, k, v, window=window,
                                      return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
        want = ref.flash_attention_bwd(q, k, v, out, do, window=window)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == dtype and _rel_err(g, w) <= tol
    for S, with_h0 in ((1, True), (37, False), (300, True)):
        a = torch.from_numpy((0.5 + 0.499 * rng.random((2, S, 33)))
                             .astype(np.float32)).to(cuda_device)
        b, dh = (torch.from_numpy(rng.standard_normal((2, S, 33))
                                  .astype(np.float32)).to(cuda_device)
                 for _ in range(2))
        h0 = (torch.from_numpy(rng.standard_normal((2, 33)).astype(
            np.float32)).to(cuda_device) if with_h0 else None)
        h = lru.lru_scan(a, b, h0)
        got = lru.lru_scan_bwd(a, h, dh, h0, want_dh0=True)
        want = ref.lru_scan_bwd(a, h, dh, h0)
        for g, w in zip(got, want, strict=True):
            assert (g is None) == (w is None)
            if w is not None:
                assert _rel_err(g, w) <= 1e-5


def test_raw_launchers_refuse_inputs_that_require_grad(cuda_device):
    """The raw launchers' outputs carry no autograd history, so with grad
    mode on they raise on an input that requires grad; ops goes through
    the autograd Functions instead and gives the gradient."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as lru

    q = torch.randn((1, 2, 64, 16), device=cuda_device, requires_grad=True)
    a = torch.rand((1, 8, 4), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="requires grad"):
        lru.lru_scan(a, a)
    with torch.no_grad():
        fa.flash_attention(q, q, q)
        lru.lru_scan(a, a)
    ops.flash_attention(q, q, q).sum().backward()
    ops.lru_scan(a, a).sum().backward()
    assert q.grad is not None and a.grad is not None


def test_mixers_get_gradients_through_the_kernels(cuda_device):
    """attn_forward and rglru_forward on a card: q, k, v (and every
    projection) get non-zero gradients through the kernels, equal to the
    plain route's within bf16 rounding (3e-2 of the largest magnitude)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.nn import attention as attn
    from repro_torch.nn import recurrent as rec

    cfg = reduced(get_config("recurrentgemma-2b"), head_dim=64)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    x = torch.randn((2, 32, cfg.d_model), device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    pos = torch.arange(32, device=cuda_device, dtype=torch.int32)[None] \
        .expand(2, 32)
    for mixer, fwd in (
            (attn.init_attn(cfg, gen, cuda_device, trainable=True),
             lambda p, h, uk: attn.attn_forward(p, h, cfg, "local", pos,
                                                use_kernel=uk)),
            (rec.init_rglru_block(cfg, gen, cuda_device, trainable=True),
             lambda p, h, uk: rec.rglru_forward(p, h, cfg, use_kernel=uk))):
        grads = []
        for use_kernel in (None, False):
            mixer.zero_grad(set_to_none=True)
            h = x.clone().requires_grad_()
            fwd(mixer, h, use_kernel).float().square().sum().backward()
            grads.append({"x": h.grad, **{n: p.grad for n, p in
                                          mixer.named_parameters()}})
        for name, g in grads[0].items():
            assert g is not None and float(g.abs().max()) > 0, name
            assert _rel_err(g, grads[1][name]) <= 3e-2, name


def test_train_step_remat_policies_and_bf16_backward(cuda_device):
    """On a card, through the kernels: remat "none" and "dots" give the
    gradients "full" gives (the kernels are deterministic, so equal), and
    bf16_backward_scope's gradients stay within bf16 rounding of them
    (5e-2 of each gradient's largest magnitude); every launch count
    follows launches_per_step's rule."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.nn.layers import bf16_backward_scope

    cfg = reduced(get_config("recurrentgemma-2b"), num_layers=5,
                  head_dim=64)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    model = tf.init_params(cfg, gen, cuda_device, trainable=True)
    rng = np.random.default_rng(3)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32))}

    def grads(c, bwd16=False):
        model.zero_grad(set_to_none=True)
        ops.reset_launch_counts()
        with bf16_backward_scope(bwd16):
            steps.loss_fn(model, c, batch)[0].backward()
        counts = ops.launch_counts()
        return {n: p.grad for n, p in model.named_parameters()}, counts

    full, counts = grads(cfg)
    # one unit (rglru, rglru, local) under remat, a tail of two rglru
    assert (counts["lru_scan"], counts["lru_scan_bwd"],
            counts["flash_attention"], counts["flash_attention_bwd"]) \
        == (6, 4, 2, 1)
    # "dots" reruns the unit in the backward too (it keeps only the
    # products' outputs), "none" does not
    for remat, fa_launches in (("none", 1), ("dots", 2)):
        got, counts = grads(dataclasses.replace(cfg, remat=remat))
        assert counts["flash_attention"] == fa_launches, remat
        for n, g in full.items():
            torch.testing.assert_close(got[n], g, rtol=0, atol=0, msg=n)
    got, _ = grads(cfg, bwd16=True)
    for n, g in full.items():
        assert _rel_err(got[n], g) <= 5e-2, n


def test_wgmma_backward_matches_plain_and_is_deterministic(cuda_device):
    """The tensor-core backward (bf16 at hd 64-256) at chip_smoke.py's bf16
    edge shapes: ragged S with a window off the tile grid and GQA 4, and S
    one row past a tile. It launches the wgmma route, stays within 1e-2 of
    each gradient's largest magnitude, and a second call gives the same
    bits (no atomics, sums in a fixed order)."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(7)
    for B, Hq, Hkv, S, hd, window in ((1, 8, 2, 1000, 128, 300),
                                      (2, 4, 4, 4097, 64, None)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda_device, torch.bfloat16) for s in (
            (B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
            (B, Hq, S, hd)))
        out, lse = fa.flash_attention(q, k, v, window=window,
                                      return_lse=True)
        ops.reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
        assert ops.route_counts()["flash_attention_bwd"] == {"wgmma": 1,
                                                             "simt": 0}
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, window=window)
        want = ref.flash_attention_bwd(q, k, v, out, do, window=window)
        for x, y, w in zip(got, again, want, strict=True):
            assert x.dtype == torch.bfloat16 and _rel_err(x, w) <= 1e-2
            assert torch.equal(x, y)


def test_chunked_lru_scan_bwd_edges_match_plain(cuda_device):
    """The chunked backward scan at S below, at, one past the chunk length
    and one past a multiple of it, with and without h0: within 1e-5 of the
    sequential plain version, and the same bits on a second call."""
    from repro_torch.kernels import lru_scan as lru

    L = lru.BWD_CHUNK
    rng = np.random.default_rng(8)
    for S in (1, L - 1, L, L + 1, 4096 + 3):
        a = torch.from_numpy((0.5 + 0.499 * rng.random((2, S, 40)))
                             .astype(np.float32)).to(cuda_device)
        b, dh = (torch.from_numpy(rng.standard_normal((2, S, 40))
                                  .astype(np.float32)).to(cuda_device)
                 for _ in range(2))
        for h0 in (None, torch.from_numpy(rng.standard_normal((2, 40))
                                          .astype(np.float32))
                   .to(cuda_device)):
            h = lru.lru_scan(a, b, h0)
            got = lru.lru_scan_bwd(a, h, dh, h0, want_dh0=True)
            again = lru.lru_scan_bwd(a, h, dh, h0, want_dh0=True)
            want = ref.lru_scan_bwd(a, h, dh, h0)
            for x, y, w in zip(got, again, want, strict=True):
                assert (x is None) == (w is None)
                if w is not None:
                    assert _rel_err(x, w) <= 1e-5 and torch.equal(x, y)
