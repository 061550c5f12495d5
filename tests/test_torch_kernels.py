"""Port kernels (``repro_torch.kernels``) against the JAX package's Pallas
kernels run in interpret mode.

On the CPU the port's dispatcher takes the plain PyTorch versions; those
must give the Pallas functions' answers: byte-identical for the stamp
kernels, within the reference's tolerances (``tests/test_kernels.py``) for
the float32/bf16 segment sums. The CUDA kernels themselves are compared
with the plain versions in ``tests/test_torch_cuda.py`` (needs a card)
and by ``chip_smoke.py``.
"""
import contextlib
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import assert_same  # noqa: E402

from repro.core import versioned as rv  # noqa: E402
from repro.kernels import segment_sum as pallas_ss  # noqa: E402
from repro.kernels import snapshot_resolve as pallas_sr  # noqa: E402
from repro_torch.core import versioned as tv  # noqa: E402
from repro_torch.kernels import _lib as cuda_lib  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_sum as cuda_ss  # noqa: E402
from repro_torch.kernels import snapshot_resolve as cuda_sr  # noqa: E402

NEVER = np.iinfo(np.int32).max


def _stamps(rng, n):
    """Packed stamps as the store keeps them: created epochs, later
    deletes, about half never deleted (the int32-max sentinel)."""
    epoch = rng.integers(0, 8, n).astype(np.int32)
    created = (epoch << 20).astype(np.int32)
    deleted = ((epoch + rng.integers(1, 4, n)) << 20).astype(np.int32)
    deleted[rng.random(n) < 0.5] = NEVER
    return created, deleted


QUERIES = [0, rv.pack32_clamped(rv.Version(3, 0)),
           rv.pack32_clamped(rv.Version(3, 1 << 30)),      # clamped number
           rv.pack32_clamped(rv.Version(1 << 30, 0)),      # clamped epoch
           rv.pack32_clamped(rv.Version(1 << 30, 1 << 30))]  # both: max


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
def test_liveness_mask_matches_pallas(n):
    created, deleted = _stamps(np.random.default_rng(n), n)
    assert QUERIES[-1] == NEVER - 1
    for q in QUERIES:
        want = pallas_sr.liveness_mask(jnp.asarray(created),
                                       jnp.asarray(deleted), q,
                                       interpret=True)
        got = ops.liveness_mask(torch.from_numpy(created),
                                torch.from_numpy(deleted), q)
        assert_same(got, want, f"liveness_mask n={n} q={q}")


@pytest.mark.parametrize("n,k", [(0, 4), (5, 1), (300, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_snapshot_resolve_matches_pallas(n, k, dtype):
    rng = np.random.default_rng(7 * n + k)
    versions = np.sort(rng.integers(0, 64, (n, k)), axis=1).astype(np.int32)
    fill = rng.integers(0, k + 1, (n, 1))
    versions = np.where(np.arange(k)[None, :] < fill, versions, NEVER) \
        .astype(np.int32)
    values = rng.integers(-100, 100, (n, k)).astype(dtype)
    for q in (-1, 0, 31, 63, NEVER - 1):
        want_v, want_i = pallas_sr.snapshot_resolve(
            jnp.asarray(versions), jnp.asarray(values), q, interpret=True)
        got_v, got_i = ops.snapshot_resolve(
            torch.from_numpy(versions), torch.from_numpy(values), q)
        assert_same(got_v, want_v, f"resolved n={n} k={k} q={q}")
        assert_same(got_i, want_i, f"index n={n} k={k} q={q}")


@pytest.mark.parametrize("m,F,n", [(0, 1, 8), (50, 1, 16), (200, 3, 40),
                                   (64, 16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_matches_pallas(m, F, n, dtype):
    rng = np.random.default_rng(m + F)
    # ascending ids over [0, n]: some segments empty, the tail rows in the
    # phantom segment n that the reference's padding convention drops
    ids = np.sort(rng.integers(0, n + 1, m)).astype(np.int32)
    vals = rng.standard_normal((m, F)).astype(np.float32)
    want = pallas_ss.segment_sum(jnp.asarray(vals, dtype), jnp.asarray(ids),
                                 n, interpret=True)
    got = ops.segment_sum(torch.from_numpy(vals).to(getattr(torch, dtype)),
                          torch.from_numpy(ids), n)
    assert got.dtype == torch.float32 and got.shape == (n, F)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _edge_ids(case):
    """Ascending ids for the one-pass kernel's edge cases (the CUDA kernel
    owns segments per 2,048-row chunk; the same cases run on the card in
    tests/test_torch_cuda.py and chip_smoke.py)."""
    if case == "phantom rows":
        return np.array([0, 0, 0, 0, 5, 5, 5, 5, 7, 7], np.int32), 7
    if case == "hub segments":      # two segments longer than three chunks
        return np.concatenate([np.full(3, 1), np.full(6_200, 2),
                               np.arange(3, 40), np.full(6_150, 41),
                               np.full(5, 42)]).astype(np.int32), 43
    if case == "empty head and tail":
        return np.repeat(np.arange(10, 30, 3), 7).astype(np.int32), 40
    if case == "m not a multiple of 4":
        return np.sort(np.random.default_rng(3).integers(0, 21, 4_099)) \
            .astype(np.int32), 20
    raise ValueError(case)


@pytest.mark.parametrize("case", ["phantom rows", "hub segments",
                                  "empty head and tail",
                                  "m not a multiple of 4"])
@pytest.mark.parametrize("F", [1, 3])
def test_segment_sum_empty_segments_and_phantom_rows(case, F):
    """The plain version the CUDA kernel is held to equals the Pallas
    kernel (interpret mode) on the same seeded inputs, within float32
    rounding (1e-4 relative: hubs of 6,000 rows summed in two orders)."""
    ids, n = _edge_ids(case)
    vals = np.random.default_rng(len(ids) + F).standard_normal(
        (len(ids), F)).astype(np.float32)
    got = ref.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), n)
    want = pallas_ss.segment_sum(jnp.asarray(vals), jnp.asarray(ids), n,
                                 interpret=True)
    assert got.dtype == torch.float32 and got.shape == (n, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    present = np.zeros(n, bool)
    present[ids[ids < n]] = True
    assert (got.numpy()[~present] == 0).all()       # empty segments are 0
    if case == "phantom rows":   # id 7 = n: the phantom row is dropped
        ones = ref.segment_sum(torch.ones((10, 4)), torch.from_numpy(ids), n)
        assert ones[1:5].sum() == 0 and ones[6].sum() == 0
        assert ones[0].sum() == 16 and ones[5].sum() == 16


ROUTE_CASES = [
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 16, "simt")]


@pytest.mark.parametrize("dtype,hd,want", ROUTE_CASES)
def test_flash_attention_route(dtype, hd, want):
    assert cuda_fa.route(dtype, hd) == want


class _FakeLib:
    """Stands in for the CUDA library: records which entry was called."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        return entry


@pytest.mark.parametrize("dtype,hd,want", ROUTE_CASES)
def test_flash_attention_bwd_route(monkeypatch, dtype, hd, want):
    """The backward picks its kernel with the forward's ``route``: the
    wgmma entry for bf16 at hd 64-256, the simt entry otherwise, and counts
    the launch under that route. The library and the device checks are
    stood in for, so the dispatch runs on CPU tensors."""
    fake = _FakeLib()
    monkeypatch.setattr(cuda_fa._lib, "load", lambda: fake)
    monkeypatch.setattr(cuda_fa._lib, "require",
                        lambda t, name, dtypes, ndim: None)
    monkeypatch.setattr(cuda_fa._lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_fa._lib, "on_device",
                        lambda t: contextlib.nullcontext())
    q = torch.zeros((1, 2, 8, hd), dtype=dtype)
    kv = q[:, :1].contiguous()
    lse = torch.zeros((1, 2, 8))
    ops.reset_launch_counts()
    try:
        cuda_fa.flash_attention_bwd(q, kv, kv, q, q, lse, window=4)
        assert fake.called == [{"wgmma": "rt_flash_attention_bwd_sm90",
                                "simt": "rt_flash_attention_bwd"}[want]]
        routes = ops.route_counts()["flash_attention_bwd"]
        assert routes == {r: int(r == want) for r in cuda_fa.ROUTES}
        assert ops.launch_counts()["flash_attention_bwd"] == 1
    finally:
        ops.reset_launch_counts()


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.bfloat16, 48, ValueError), (torch.float32, 512, ValueError),
    (torch.float16, 64, TypeError)])
def test_flash_attention_rejects_before_touching_the_library(
        monkeypatch, dtype, hd, err):
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(cuda_fa._lib, "load", no_library)
    q = torch.zeros((1, 2, 8, hd), dtype=dtype)
    with pytest.raises(err):
        cuda_fa.route(dtype, hd)
    with pytest.raises(err):
        cuda_fa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(err):
        cuda_fa.flash_attention_bwd(q, q[:, :1], q[:, :1], q, q,
                                    torch.zeros(q.shape[:3]))


def test_kernel_digest_follows_headers_and_flags(tmp_path, monkeypatch):
    """A changed header under csrc/ or a changed link flag gives another
    library name, so the build runs again."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    assert list(csrc.glob("*.cuh")), "no shared header to edit"
    before = cuda_lib._digest(csrc)
    assert cuda_lib._digest(csrc) == before
    header = next(iter(sorted(csrc.glob("*.cuh"))))
    header.write_bytes(header.read_bytes() + b"\n")
    after = cuda_lib._digest(csrc)
    assert after != before
    monkeypatch.setattr(cuda_lib, "LINK_FLAGS", cuda_lib.LINK_FLAGS + ("-g",))
    assert cuda_lib._digest(csrc) != after


def test_use_kernel_true_on_cpu_raises():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.liveness_mask(t, t, 0, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.snapshot_resolve(t[None, :], t[None, :].float(), 0,
                             use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.segment_sum(torch.zeros(4, 1), t, 2, use_kernel=True)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    ops.reset_launch_counts()
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_sr.liveness_mask(t, t, 0)
    with pytest.raises(ValueError):
        cuda_sr.snapshot_resolve(t[None, :], t[None, :], 0)
    with pytest.raises(ValueError):
        cuda_ss.segment_sum(torch.zeros(4, 1), t, 2)
    # use_kernel=False and the CPU default take the plain versions
    ops.liveness_mask(t, t, 0)
    ops.liveness_mask(t, t, 0, use_kernel=False)
    assert ops.launch_counts() == {"liveness_mask": 0, "snapshot_resolve": 0,
                                   "segment_sum": 0, "lru_scan": 0,
                                   "lru_scan_bwd": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0}
    assert ops.route_counts() == {
        "flash_attention": {"wgmma": 0, "simt": 0},
        "flash_attention_bwd": {"wgmma": 0, "simt": 0}}


@pytest.mark.parametrize("k", [1, 3])
def test_versioned_array_read_snapshot_matches_reference(k):
    rng = np.random.default_rng(k)
    n = 12
    port = tv.VersionedArray(n, k, device="cpu")
    jref = rv.VersionedArray(n, k)
    for epoch in range(k):
        ids = np.sort(rng.choice(n, size=n // 2, replace=False))
        vals = rng.standard_normal(len(ids)).astype(np.float32)
        port.write(ids, tv.Version(epoch, 0), vals)
        jref.write(jnp.asarray(ids), rv.Version(epoch, 0), jnp.asarray(vals))
    assert_same(port.versions, jref.versions)
    assert_same(port.fill, jref.fill)
    for epoch in range(-1, k + 1):
        v = (epoch, 0) if epoch >= 0 else (0, 0)
        assert_same(port.read_snapshot(tv.Version(*v), default=-1),
                    jref.read_snapshot(rv.Version(*v), default=-1),
                    f"read_snapshot at {v}")
    assert_same(tv.resolve_versions(port.versions, 1 << 20),
                rv.resolve_versions(jref.versions, 1 << 20))


def test_version_packing_is_the_reference_packing():
    for v in [(0, 0), (3, 7), (2047, (1 << 20) - 2), (5000, 5)]:
        assert tv.pack32_clamped(tv.Version(*v)) \
            == rv.pack32_clamped(rv.Version(*v))
    assert tv.PACK32_NEVER == rv.PACK32_NEVER
    with pytest.raises(ValueError):
        tv.pack32_checked(tv.Version(2047, (1 << 20) - 1))
