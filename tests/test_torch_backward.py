"""The plain backwards of the port's two model kernels, and the autograd
Functions that put the CUDA backward kernels under ``ops``.

``ref.flash_attention_bwd`` and ``ref.lru_scan_bwd`` (the oracles the CUDA
backward kernels are held against on the card) are checked here against
``torch.autograd`` of the plain forwards and against ``jax.grad`` of the
reference's plain versions (``repro/kernels/ref.py``: ``flash_attention``,
``lru_scan``), on the same NumPy inputs: causal, windowed, GQA, S not a
multiple of the kernels' 64-row tiles, and ``h0``. Float32 on both sides;
the sums run in other orders, so 1e-5 (relative to each gradient's largest
magnitude for attention, whose gradients reach about 10).

``FlashAttentionFn`` and ``LruScanFn`` run on the CPU with the plain
versions standing in for the raw launchers, so their plumbing (what they
save, the arguments they pass, the gradients they return) is checked
without a card; the kernels themselves are checked on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels import lru_scan as cuda_lru  # noqa: E402

ATTN_CASES = [  # B, Hq, Hkv, S, hd, causal, window
    (2, 4, 2, 37, 16, True, None),
    (1, 4, 1, 70, 32, True, 9),
    (1, 2, 2, 65, 16, True, 64),
    (1, 6, 3, 20, 16, False, None),
    (1, 2, 1, 24, 16, False, 5),
]


def _attn_inputs(B, Hq, Hkv, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
             (B, Hq, S, hd))]


def _rel_close(got, want, what, tol=1e-5):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    assert g.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max()) / scale
    assert err <= tol, f"{what}: {err} of its largest magnitude > {tol}"


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal,window", ATTN_CASES)
def test_flash_attention_bwd_matches_autograd_and_jax(B, Hq, Hkv, S, hd,
                                                      causal, window):
    q, k, v, do = _attn_inputs(B, Hq, Hkv, S, hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    dq, dk, dv = ref.flash_attention_bwd(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(do), causal=causal, window=window)

    def jfn(q, k, v):
        return jnp.sum(jref.flash_attention(q, k, v, causal=causal,
                                            window=window) * do)
    jgrads = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, got, auto, want in zip("qkv", (dq, dk, dv),
                                     (tq.grad, tk.grad, tv.grad), jgrads,
                                     strict=True):
        _rel_close(got, auto.numpy(), f"d{name} vs autograd")
        _rel_close(got, want, f"d{name} vs jax.grad")


def test_flash_attention_bwd_keeps_dtype_and_sums_groups():
    """bf16 in, bf16 out; with one kv head the key and value gradients
    are the sums over all query heads' contributions."""
    q, k, v, do = _attn_inputs(1, 4, 1, 16, 16, seed=1)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    out = ref.flash_attention(*t[:3])
    dq, dk, dv = ref.flash_attention_bwd(*t[:3], out, t[3])
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    per_head = [ref.flash_attention_bwd(
        t[0][:, h:h + 1], t[1], t[2], out[:, h:h + 1], t[3][:, h:h + 1])
        for h in range(4)]
    dk_sum = sum(p[1].float() for p in per_head)
    torch.testing.assert_close(dk.float(), dk_sum, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("B,S,C,with_h0", [(2, 13, 5, False),
                                           (2, 13, 5, True),
                                           (1, 70, 3, True),
                                           (3, 1, 4, True)])
def test_lru_scan_bwd_matches_autograd_and_jax(B, S, C, with_h0):
    rng = np.random.default_rng(2)
    a = (0.5 + 0.499 * rng.random((B, S, C))).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((B, S, C)).astype(np.float32)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    th0 = torch.from_numpy(h0).requires_grad_() if with_h0 else None
    h = ref.lru_scan(ta, tb, th0)
    h.backward(torch.from_numpy(dh))
    da, db, dh0 = ref.lru_scan_bwd(ta.detach(), h.detach(),
                                   torch.from_numpy(dh),
                                   None if h0 is None else th0.detach())

    # the reference's scan has no h0: h0 enters as b_0 + a_0 h0
    def jfn(a, b, h0):
        if h0 is not None:
            b = b.at[:, 0].add(a[:, 0] * h0)
        return jnp.sum(jref.lru_scan(a, b) * dh)
    jargs = (jnp.asarray(a), jnp.asarray(b),
             None if h0 is None else jnp.asarray(h0))
    jda, jdb, jdh0 = jax.grad(jfn, argnums=(0, 1, 2))(*jargs) \
        if with_h0 else (*jax.grad(jfn, argnums=(0, 1))(*jargs), None)
    for name, got, auto, want in (("a", da, ta.grad, jda),
                                  ("b", db, tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name} autograd")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name} jax")
    if with_h0:
        np.testing.assert_allclose(dh0.numpy(), th0.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(dh0.numpy(), np.asarray(jdh0), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert dh0 is None


def _lru_scan_bwd_chunked(a: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor, h0: torch.Tensor | None = None, *,
                         chunk: int):
    """``ref.lru_scan_bwd`` computed as the CUDA kernel computes it
    (``csrc/lru_scan.cu``): time in chunks of ``chunk`` steps, all chunks
    at once. Pass 1 walks each chunk backwards with no carry in, giving
    G_k = a_{t0} g_{t0} at its first step t0 and A_k, the product of a over
    it; the carry into chunk k is c_k = G_{k+1} + A_{k+1} c_{k+1} (0 for
    the last); pass 2 walks each chunk again from g = dh + c_k at its last
    step. The last chunk is padded with a = 1 and dh = 0, which adds
    nothing. Returns (da, db, dh0) as ``ref.lru_scan_bwd``."""
    B, S, C = a.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def chunks(x, fill):
        x = torch.cat([x, x.new_full((B, pad, C), fill)], dim=1)
        return x.reshape(B, n, chunk, C)
    zeros = torch.zeros((B, 1, C), dtype=torch.float32, device=a.device)
    prev = torch.cat([zeros if h0 is None else h0[:, None].float(),
                      h[:, :-1]], dim=1)[:, :S]
    ac, gc, hc = chunks(a, 1.0), chunks(dh, 0.0), chunks(prev, 0.0)
    g = torch.zeros((B, n, C), dtype=torch.float32, device=a.device)
    a_next, prod = torch.zeros_like(g), torch.ones_like(g)
    for u in range(chunk - 1, -1, -1):
        g = a_next * g + gc[:, :, u]
        a_next = ac[:, :, u]
        prod = prod * a_next
    G, A = a_next * g, prod
    carry = torch.zeros_like(g)
    for k in range(n - 2, -1, -1):
        carry[:, k] = G[:, k + 1] + A[:, k + 1] * carry[:, k + 1]
    da, db = torch.empty_like(ac), torch.empty_like(ac)
    g, a_next = carry, torch.ones_like(g)
    for u in range(chunk - 1, -1, -1):
        g = a_next * g + gc[:, :, u]
        db[:, :, u] = g
        da[:, :, u] = g * hc[:, :, u]
        a_next = ac[:, :, u]
    da = da.reshape(B, n * chunk, C)[:, :S]
    db = db.reshape(B, n * chunk, C)[:, :S]
    if h0 is None:
        return da, db, None
    return da, db, (a[:, 0] * db[:, 0] if S else torch.zeros_like(h0))


L = cuda_lru.BWD_CHUNK   # the chunk length the CUDA backward is given


@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 3 * L + 5])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_bwd_chunked_matches_sequential_and_jax(S, with_h0):
    """The CUDA backward's decomposition (per-chunk carries folded from the
    right, then each chunk walked again), written out in plain torch with
    the wrapper's chunk length: equal to the sequential plain backward and
    to jax.grad of the reference's scan within 1e-6 of each gradient's
    largest magnitude, at S below, at, one past and several chunks past
    the chunk length."""
    rng = np.random.default_rng(S)
    B, C = 2, 6
    a = (0.5 + 0.499 * rng.random((B, S, C))).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((B, S, C)).astype(np.float32)
    ta, tdh = torch.from_numpy(a), torch.from_numpy(dh)
    th0 = None if h0 is None else torch.from_numpy(h0)
    h = ref.lru_scan(ta, torch.from_numpy(b), th0)
    got = _lru_scan_bwd_chunked(ta, h, tdh, th0, chunk=L)
    seq = ref.lru_scan_bwd(ta, h, tdh, th0)

    def jfn(a, b, h0):
        if h0 is not None:
            b = b.at[:, 0].add(a[:, 0] * h0)
        return jnp.sum(jref.lru_scan(a, b) * dh)
    jargs = (jnp.asarray(a), jnp.asarray(b),
             None if h0 is None else jnp.asarray(h0))
    jgrads = jax.grad(jfn, argnums=(0, 1, 2) if with_h0 else (0, 1))(*jargs)
    for i, name in enumerate(("da", "db", "dh0")):
        if not with_h0 and name == "dh0":
            assert got[i] is None and seq[i] is None
            continue
        _rel_close(got[i], seq[i].numpy(), f"{name} vs sequential", 1e-6)
        _rel_close(got[i], jgrads[i], f"{name} vs jax.grad", 1e-6)


# ------------------------------------------------- the autograd Functions
@pytest.fixture
def plain_launchers(monkeypatch):
    """The raw launchers replaced by the plain versions (CPU tensors),
    counting calls; the lse comes from the plain scores."""
    calls = {"fwd": [], "bwd": [], "lru": 0, "lru_bwd": []}

    def fwd(q, k, v, *, causal=True, window=None, return_lse=False):
        calls["fwd"].append(return_lse)
        out = ref.flash_attention(q, k, v, causal=causal, window=window)
        if not return_lse:
            return out
        B, H, S, hd = q.shape
        qf = q.float().reshape(B, k.shape[1], H // k.shape[1], S, hd)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * hd ** -0.5
        sc.masked_fill_(~ref._mask(S, causal, window, q.device), -1e30)
        return out, torch.logsumexp(sc, -1).reshape(B, H, S)

    def bwd(q, k, v, out, dout, lse, *, causal=True, window=None):
        assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
        calls["bwd"].append(window)
        return ref.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       window=window)

    def scan(a, b, h0=None):
        calls["lru"] += 1
        return ref.lru_scan(a, b, h0)

    def scan_bwd(a, h, dh, h0=None, *, want_dh0=False):
        calls["lru_bwd"].append(want_dh0)
        da, db, dh0 = ref.lru_scan_bwd(a, h, dh, h0)
        return da, db, dh0 if want_dh0 else None

    monkeypatch.setattr(cuda_fa, "flash_attention", fwd)
    monkeypatch.setattr(cuda_fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(cuda_lru, "lru_scan", scan)
    monkeypatch.setattr(cuda_lru, "lru_scan_bwd", scan_bwd)
    return calls


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_fn_gradients(plain_launchers, window):
    q, k, v, do = _attn_inputs(1, 4, 2, 19, 16, seed=3)
    grads = []
    for fn in (lambda *t: cuda_fa.FlashAttentionFn.apply(*t, True, window),
               lambda *t: ref.flash_attention(*t, window=window)):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn(*t).backward(torch.from_numpy(do))
        grads.append([x.grad for x in t])
    for got, want in zip(*grads, strict=True):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert plain_launchers["fwd"] == [True]
    assert plain_launchers["bwd"] == [window]


def test_functions_keep_nothing_without_grad(plain_launchers):
    """Serving (no input needs a gradient): no lse is asked for."""
    q, k, v, _ = _attn_inputs(1, 2, 1, 8, 16)
    with torch.inference_mode():
        cuda_fa.FlashAttentionFn.apply(*map(torch.from_numpy, (q, k, v)),
                                       True, None)
        a = torch.full((1, 4, 3), 0.5)
        cuda_lru.LruScanFn.apply(a, a, None)
    assert plain_launchers["fwd"] == [False]
    assert plain_launchers["lru"] == 1


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_fn_gradients(plain_launchers, with_h0):
    rng = np.random.default_rng(4)
    a = (0.5 + 0.499 * rng.random((2, 11, 3))).astype(np.float32)
    b = rng.standard_normal((2, 11, 3)).astype(np.float32)
    h0 = rng.standard_normal((2, 3)).astype(np.float32)
    dh = torch.from_numpy(rng.standard_normal((2, 11, 3)).astype(np.float32))
    grads = []
    for fn in (cuda_lru.LruScanFn.apply, ref.lru_scan):
        t = [torch.from_numpy(x).requires_grad_() for x in (a, b)]
        t0 = torch.from_numpy(h0).requires_grad_() if with_h0 else None
        fn(*t, t0).backward(dh)
        grads.append([x.grad for x in t] + ([t0.grad] if with_h0 else []))
    for got, want in zip(*grads, strict=True):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert plain_launchers["lru_bwd"] == [with_h0]


def test_raw_launcher_guard_refuses_inputs_that_require_grad():
    """The Step-0 guard: with grad mode on, an input that requires grad
    makes the raw launchers raise (their output has no autograd history);
    under no_grad, or for inputs without grad, they do not."""
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        _lib.refuse_grad("flash_attention", None, t)
    with torch.no_grad():
        _lib.refuse_grad("flash_attention", t)
    _lib.refuse_grad("lru_scan", torch.zeros(3), None)


def test_ops_backward_on_cpu_takes_the_plain_route():
    """On CPU tensors ``ops`` differentiates the plain versions: no kernel
    launch is counted, and the gradients are autograd's."""
    ops.reset_launch_counts()
    q, k, v, do = _attn_inputs(1, 2, 1, 10, 16, seed=5)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*t, window=4).backward(torch.from_numpy(do))
    a = torch.full((1, 5, 2), 0.7, requires_grad=True)
    ops.lru_scan(a, a).sum().backward()
    assert all(x.grad is not None for x in t) and a.grad is not None
    assert not any(ops.launch_counts().values())
