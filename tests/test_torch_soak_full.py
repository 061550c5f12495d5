"""The full-scale soak of ``tests/test_soak.py`` on the port: eight RPC
clients with randomized deadlines and pinned reads over a twelve-epoch
churn stream with a split and a merge, heavier stalls and tighter
deadline pressure; every successful non-PageRank answer byte-identical to
the JAX package's single-store replay at its served version (the audit of
``tests/test_torch_soak.py``'s ``_run_soak``). Marked ``soak``, as the
reference's is.
"""
import pytest

pytest.importorskip("torch")

from test_torch_soak import _run_soak  # noqa: E402


@pytest.mark.soak
def test_soak_full_scale():
    """The acceptance soak: 8 clients, a longer churn stream, heavier
    stalls and tighter deadline pressure; the result cache and the
    publish-time prewarm both served."""
    stats = _run_soak(n=128, epochs=12, adds=200, n_clients=8,
                      per_client=40, stall_s=0.08, ingest_delay_s=0.02)
    assert stats.served > 0
    assert stats.split_events == 1 and stats.merge_events == 1
    assert stats.result_cache_hits > 0
    assert stats.prewarm_runs > 0
