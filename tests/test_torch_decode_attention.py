"""The decode step's attention as one kernel (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``) and ``attn_decode``'s two routes, on the CPU:
the wrapper's refusals, the C binding, the split count, the plain version
against the plain decode's arithmetic, the split-and-combine the kernel
runs (emulated in float64 here) against the unsplit softmax, and the meta
count of a decode step. The kernel itself is held to the plain version on
a card by ``tests/test_torch_decode_attention_cuda.py`` and by
``chip_smoke.py``.
"""
import ctypes
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_da  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn.layers import dense  # noqa: E402


def _inputs(seed, B, Hq, Hkv, cap, hd, dtype=torch.float32,
            device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hq, hd), generator=g).to(dtype).to(device)
    k = torch.randn((B, Hkv, cap, hd), generator=g).to(dtype).to(device)
    v = torch.randn((B, Hkv, cap, hd), generator=g).to(dtype).to(device)
    return q, k, v


def _meta(B=2, Hq=8, Hkv=2, cap=16, hd=64, dtype=torch.bfloat16):
    return (torch.empty((B, Hq, hd), dtype=dtype, device="meta"),
            torch.empty((B, Hkv, cap, hd), dtype=dtype, device="meta"),
            torch.empty((B, Hkv, cap, hd), dtype=dtype, device="meta"))


@pytest.mark.parametrize("fault", ["cpu", "float16", "mixed_dtypes",
                                   "head_dim_48", "non_contiguous",
                                   "pos_past_capacity", "pos_negative",
                                   "window_zero", "hq_not_multiple",
                                   "cache_shapes_differ"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """A CPU tensor, and on meta tensors (standing for CUDA ones, which
    pass the device check) each shape, dtype, layout, position and window
    the kernel does not take; nothing is launched."""
    q, k, v = _meta()
    pos, window, err = 3, None, ValueError
    if fault == "cpu":
        q, k, v = _inputs(0, 2, 8, 2, 16, 64)
    elif fault == "float16":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
        err = (TypeError, ValueError)
    elif fault == "mixed_dtypes":
        v, err = v.float(), TypeError
    elif fault == "head_dim_48":
        q, k, v = _meta(hd=48)
    elif fault == "non_contiguous":
        k = torch.empty((2, 2, 64, 16), dtype=torch.bfloat16,
                        device="meta").transpose(2, 3)
    elif fault == "pos_past_capacity":
        pos = 16
    elif fault == "pos_negative":
        pos = -1
    elif fault == "window_zero":
        window = 0
    elif fault == "hq_not_multiple":
        q, k, v = _meta(Hq=6, Hkv=4)
    elif fault == "cache_shapes_differ":
        v = torch.empty((2, 2, 15, 64), dtype=torch.bfloat16, device="meta")
    ops.reset_launch_counts()
    with pytest.raises(err):
        cuda_da.decode_attention(q, k, v, pos, window=window)
    assert ops.launch_counts()["decode_attention"] == 0


def test_c_entries_are_declared_and_built():
    assert "decode_attention.cu" in _lib.SOURCES
    P, i = ctypes.c_void_p, ctypes.c_int
    restype, argtypes = _lib._SIGNATURES["rt_decode_attention"]
    # q, k, v, out, part; dtype, B, Hq, Hkv, cap, hd, pos, window, splits;
    # scale; stream
    assert restype is i
    assert argtypes == [P] * 5 + [i] * 9 + [ctypes.c_float, P]
    restype, argtypes = _lib._SIGNATURES["rt_decode_attention_combine"]
    # part, out; dtype, B, Hq, Hkv, hd, splits; stream
    assert restype is i and argtypes == [P, P] + [i] * 6 + [P]
    source = (_lib.CSRC / "decode_attention.cu").read_text()
    kernels = [line.split("(")[0].split()[-1] for line in source.splitlines()
               if line.startswith("decode_attention_kernel")]
    assert len(kernels) == 3
    for name in kernels:
        assert "decode_attention_kernel" in name
        assert "flash_attention" not in name and "segment_sum" not in name


@pytest.mark.parametrize("B,Hq,Hkv,hd,length,want", [
    (48, 40, 8, 128, 2048, 1),      # qwen2.5-14b.batch2k: 384 blocks
    (48, 40, 8, 128, 1, 1),
    (16, 40, 8, 128, 2176, 3),      # 128 blocks: 2 x 132 wanted
    (2, 40, 8, 128, 32768, 17),     # a long cache at a small batch
    (8, 10, 1, 256, 2048, 32),      # recurrentgemma: 128 tiles / 4
    (1, 48, 8, 128, 100, 1),        # 4 tiles: one split
])
def test_split_count_follows_the_shape(B, Hq, Hkv, hd, length, want):
    got = cuda_da.split_count(torch.bfloat16, B, Hq, Hkv, hd, length, 132)
    assert got == want
    tiles = math.ceil(length / cuda_da.TILE_POSITIONS[hd])
    assert 1 <= got <= max(1, tiles // cuda_da.MIN_TILES)


def test_attended_range():
    assert cuda_da.attended(0, None) == (0, 1)
    assert cuda_da.attended(2175, None) == (0, 2176)
    assert cuda_da.attended(1022, 1024) == (0, 1023)
    assert cuda_da.attended(1023, 1024) == (0, 1024)
    assert cuda_da.attended(1024, 1024) == (1, 1024)
    assert cuda_da.attended(5000, 1024) == (3977, 1024)


def _plain_decode(qg, ck, cv, pos, window, hd):
    """The decode attention of the port's plain ``attn_decode`` before the
    kernel route (qg: (B, Hkv, G, 1, hd)), line for line."""
    scores = torch.einsum("bhgqd,bhcd->bhgqc", qg.float(),
                          ck.float()) * hd ** -0.5
    idx = torch.arange(ck.shape[2], device=qg.device)
    mask = idx <= pos
    if window is not None:
        mask = mask & (pos - idx < window)
    scores = scores.masked_fill(~mask, attn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqc,bhcd->bhgqd", probs.to(cv.dtype).float(),
                        cv.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,pos", [(None, 0), (None, 23), (8, 5),
                                        (8, 7), (8, 20)])
def test_plain_version_is_the_plain_decode(dtype, window, pos):
    B, Hq, Hkv, cap, hd = 2, 10, 2, 24, 16
    q, k, v = _inputs(pos + 1, B, Hq, Hkv, cap, hd, dtype)
    want = _plain_decode(q.reshape(B, Hkv, Hq // Hkv, 1, hd), k, v, pos,
                         window, hd).reshape(B, Hq, hd).to(dtype)
    got = ops.decode_attention(q, k, v, pos, window=window)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ref.decode_attention(q, k, v, pos, window=window),
                       want)


@pytest.mark.parametrize("arch,kind", [("qwen2.5-14b", "attn"),
                                       ("recurrentgemma-2b", "local")])
def test_attn_decode_plain_route_is_the_plain_decode(arch, kind):
    """``attn_decode`` on the CPU: the cache written at pos, and the output
    the plain decode's arithmetic gives, to the bit."""
    cfg = reduced(get_config(arch))
    g = torch.Generator().manual_seed(3)
    p = attn.init_attn(cfg, g, "cpu")
    B, cap, hd = 2, 24, cfg.resolved_head_dim
    cache = attn.init_kv_cache(cfg, B, cap, "cpu")
    for c in cache.values():
        c.normal_(generator=g)
    for pos in (0, 9, 20):
        x = torch.randn((B, 1, cfg.d_model), generator=g)
        positions = torch.full((B, 1), pos, dtype=torch.int32)
        q, k, v = attn._project_qkv(p, x, cfg, positions)
        before = {n: c.clone() for n, c in cache.items()}
        got, cache = attn.attn_decode(p, x, cfg, kind, cache, pos)
        before["k"][:, :, pos:pos + 1] = k
        before["v"][:, :, pos:pos + 1] = v
        assert all(torch.equal(cache[n], before[n]) for n in cache)
        out = _plain_decode(attn._gqa_shape(q, cfg.n_kv_heads), cache["k"],
                            cache["v"], pos, attn.window_for(kind, cfg), hd)
        out = out.reshape(B, cfg.n_heads, 1, hd).transpose(1, 2) \
            .reshape(B, 1, cfg.q_dim)
        assert torch.equal(got, dense(out.to(x.dtype), p.wo))


def test_attn_decode_kernel_route_needs_a_card():
    cfg = reduced(get_config("qwen2.5-14b"))
    p = attn.init_attn(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = attn.init_kv_cache(cfg, 2, 8, "cpu")
    x = torch.zeros((2, 1, cfg.d_model))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        attn.attn_decode(p, x, cfg, "attn", cache, 3, use_kernel=True)
    assert ops.launch_counts()["decode_attention"] == 0


def test_stand_ins_for_the_prefill_kernels_keep_the_decode_plain(
        monkeypatch):
    """Tests that put plain versions in for the prefill's kernels patch
    ``ops.wants_kernel`` to say yes on the CPU; the decode's kernel route
    still asks for a card, so the decode stays on its plain route."""
    monkeypatch.setattr(ops, "wants_kernel",
                        lambda t, use_kernel: use_kernel is not False)
    cfg = reduced(get_config("qwen2.5-14b"))
    p = attn.init_attn(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = attn.init_kv_cache(cfg, 2, 8, "cpu")
    y, _ = attn.attn_decode(p, torch.ones((2, 1, cfg.d_model)), cfg, "attn",
                            cache, 3)
    assert y.shape == (2, 1, cfg.d_model)


def _split_emulation(q, k, v, pos, window, splits, tile):
    """The kernel's arithmetic in float64: the attended range in tiles of
    ``tile`` positions, cut into ``splits`` runs of whole tiles (some may
    be empty); each run's max, sum and unnormalised accumulator in base 2,
    then the combine in split order."""
    B, Hq, hd = q.shape
    Hkv = k.shape[1]
    start, length = cuda_da.attended(pos, window)
    qf = q.double().reshape(B, Hkv, Hq // Hkv, hd) * hd ** -0.5 \
        / math.log(2)
    kf = k.double()[:, :, start:pos + 1]
    vf = v.double()[:, :, start:pos + 1]
    s2 = torch.einsum("bhgd,bhcd->bhgc", qf, kf)
    tiles = math.ceil(length / tile)
    parts = []
    for s in range(splits):
        lo = tiles * s // splits * tile
        hi = min(length, tiles * (s + 1) // splits * tile)
        if hi <= lo:
            parts.append((torch.full(s2.shape[:3], -math.inf,
                                     dtype=torch.float64),
                          torch.zeros(s2.shape[:3], dtype=torch.float64),
                          torch.zeros((*s2.shape[:3], hd),
                                      dtype=torch.float64)))
            continue
        m = s2[..., lo:hi].amax(-1)
        p = torch.exp2(s2[..., lo:hi] - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bhgc,bhcd->bhgd", p, vf[:, :, lo:hi])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    total = torch.zeros_like(mx)
    acc = torch.zeros((*mx.shape, hd), dtype=torch.float64)
    for m, l, a in parts:
        w = torch.exp2(m - mx)
        total = total + l * w
        acc = acc + a * w[..., None]
    return (acc / total[..., None]).reshape(B, Hq, hd)


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 17, 40])
@pytest.mark.parametrize("window,pos", [(None, 299), (None, 0), (64, 299),
                                        (64, 40)])
def test_split_and_combine_equal_the_unsplit_softmax(splits, window, pos):
    q, k, v = _inputs(splits, 2, 10, 2, 300, 32)
    got = _split_emulation(q, k, v, pos, window, splits, 16)
    want = ref.decode_attention(q.double(), k.double(), v.double(), pos,
                                window=window)
    assert float((got - want).abs().max()) < 1e-6


def test_meta_decode_step_counts_the_kernel_once_a_layer():
    """A decode step on meta tensors standing for a card: one
    ``decode_attention`` per attention layer, each with :func:`work` at
    the attended positions (a local window caps them)."""
    B, S = 2, 16
    for arch in ("qwen2.5-14b", "gemma3-27b"):
        cfg = reduced(get_config(arch))
        c = dryrun.count_step(cfg, "decode", B, S)
        layers = [k for k in list(cfg.pattern) * cfg.num_units
                  + list(cfg.tail_pattern) if k in ("attn", "swa", "local",
                                                    "global")]
        assert c["kernels"] == {"decode_attention": len(layers)}
        works = [cuda_da.work(B, cfg.n_heads, cfg.n_kv_heads,
                              cuda_da.attended(S - 1, attn.window_for(
                                  kind, cfg))[1],
                              cfg.resolved_head_dim, 2) for kind in layers]
        assert c["kernel_flops"] == sum(w["flops"] for w in works)
        assert c["kernel_bytes"] == sum(w["hbm_bytes"] for w in works)
        assert c["transcendentals"] >= sum(w["transcendentals"]
                                           for w in works)


def test_work_formula():
    w = cuda_da.work(48, 40, 8, 2048, 128, 2)
    assert w["flops"] == 4 * 128 * 48 * 40 * 2048
    assert w["hbm_bytes"] == 2 * (2 * 48 * 8 * 2048 * 128 + 2 * 48 * 40 * 128)
    assert w["transcendentals"] == 48 * 40 * 2048
