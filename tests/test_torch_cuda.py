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
        vals = torch.randn(m, f, device=cuda_device).to(dtype)
        torch.testing.assert_close(
            ops.segment_sum(vals, ids, segs, use_kernel=True),
            ref.segment_sum(vals, ids, segs), rtol=1e-5, atol=1e-5)


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
