"""Plain PyTorch versions of the port's kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the oracle every CUDA kernel is held
against on the card. Same semantics as the Pallas functions they stand
for (``repro/kernels/snapshot_resolve.py``, ``repro/kernels/segment_sum.py``,
``repro/kernels/lru_scan.py``, ``repro/kernels/flash_attention.py``), WCC's
round (``wcc_round``) and the decode step's attention
(``decode_attention``, the reference's einsum in ``repro/nn/attention.py``),
which stand for no Pallas function, and
the gradients of the last two (``lru_scan_bwd``, ``flash_attention_bwd``):
the formulas of the CUDA backward kernels written out step by step, their
oracle on the card. The CPU route differentiates ``lru_scan`` and
``flash_attention`` by autograd instead, as the reference's ``jax.grad``
differentiates its plain path.
"""
from __future__ import annotations

import torch


def liveness_mask(created: torch.Tensor, deleted: torch.Tensor,
                  query_version) -> torch.Tensor:
    """``created <= q < deleted`` per edge -> (N,) bool. Equal to the
    reference's 2-slot resolve ([created, deleted] -> [1, 0]) for every
    stamp pair, ascending or not."""
    q = int(query_version)
    return (created <= q) & (q < deleted)


def snapshot_resolve(versions: torch.Tensor, values: torch.Tensor,
                     query_version) -> tuple[torch.Tensor, torch.Tensor]:
    """(resolved (N,), index (N,) int32): the value at the largest slot
    whose version is <= q (0 if none) and that slot (-1 if none)."""
    n, k = versions.shape
    if n == 0:
        return (torch.zeros(0, dtype=values.dtype, device=values.device),
                torch.zeros(0, dtype=torch.int32, device=values.device))
    slot = torch.arange(k, dtype=torch.int32, device=versions.device)
    best = torch.where(versions <= int(query_version), slot,
                       torch.full_like(slot, -1)).amax(dim=1)
    gathered = values.gather(1, best.clamp(min=0).long()[:, None])[:, 0]
    resolved = torch.where(best >= 0, gathered, torch.zeros_like(gathered))
    return resolved, best


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values: (m, F); segment_ids: (m,) -> (num_segments, F) float32.
    Ids outside [0, num_segments) (the phantom padding row) are dropped,
    and the sum is taken in float32 whatever the input type."""
    f = values.shape[1]
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=values.device)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    out.index_add_(0, segment_ids[keep].long(), values[keep].float())
    return out


def wcc_round(src: torch.Tensor, dst: torch.Tensor,
              labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of WCC's min-label propagation over the edges (src, dst),
    as ``graph.compute.wcc``'s plain route computes it: two scatter-mins
    from the round's input labels (the reference's ``segment_min``, empty
    segments at the dtype's maximum). Returns (labels after the round,
    (1,) int32 flag: 1 if any label fell, else 0)."""
    n = labels.shape[0]
    high = torch.iinfo(labels.dtype).max
    src_ids, dst_ids = src.long(), dst.long()
    fwd = torch.full((n,), high, dtype=labels.dtype,
                     device=labels.device).scatter_reduce_(
        0, dst_ids, labels[src_ids], "amin", include_self=True)
    bwd = torch.full((n,), high, dtype=labels.dtype,
                     device=labels.device).scatter_reduce_(
        0, src_ids, labels[dst_ids], "amin", include_self=True)
    new = torch.minimum(labels, torch.minimum(fwd, bwd))
    return new, (new != labels).any().to(torch.int32).reshape(1)


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 of (B, S, C) float32 ``a``,
    ``b``, with h_{-1} = h0 ((B, C), zeros when None): a sequential loop
    over time."""
    B, S, C = a.shape
    h = (torch.zeros((B, C), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    steps = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    # one stack, not S writes into a buffer: autograd then keeps one node
    # per step instead of copying the whole gradient at every write
    if not steps:
        return torch.empty((B, 0, C), dtype=torch.float32, device=a.device)
    return torch.stack(steps, dim=1)


def lru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                 h0: torch.Tensor | None = None):
    """The gradient of :func:`lru_scan` given its coefficients ``a``, its
    output ``h`` and ``dh`` = dL/dh, all (B, S, C): walking time backwards,
    g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t, da_t = g_t h_{t-1} (h_{-1} =
    h0, or 0) and dh0 = a_0 g_0. Returns (da, db, dh0), dh0 None when h0
    is None."""
    B, S, C = a.shape
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    g = torch.zeros((B, C), dtype=torch.float32, device=a.device)
    zeros = torch.zeros_like(g)
    for t in range(S - 1, -1, -1):
        g = dh[:, t] + a[:, t + 1] * g if t + 1 < S else dh[:, t].clone()
        db[:, t] = g
        prev = h[:, t - 1] if t > 0 else (zeros if h0 is None else h0)
        da[:, t] = g * prev
    if h0 is None:
        return da, db, None
    return da, db, (a[:, 0] * g if S else torch.zeros_like(h0))


def _mask(S: int, causal: bool, window, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0. The full
    S x S softmax in float32 (``repro/kernels/ref.py``'s oracle); the
    result has q's dtype."""
    B, H, S, hd = q.shape
    hkv = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(B, hkv, H // hkv, S, hd)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    scores.masked_fill_(~_mask(S, causal, window, q.device), -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        window=None, scale=None):
    """The gradient of :func:`flash_attention` with respect to q, k, v,
    given its output ``out`` and ``dout`` = dL/dout, in float32 over the
    full S x S scores: S = scale q k^T masked, lse its row log-sum-exp,
    P = exp(S - lse), delta = rowsum(dout * out), dV = P^T dout,
    dS = P * (dout v^T - delta), dK = scale dS^T q, dQ = scale dS k; dK
    and dV sum over each kv head's group of query heads. Returns (dq, dk,
    dv) in the inputs' dtypes."""
    B, H, S, hd = q.shape
    hkv = k.shape[1]
    g = H // hkv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(B, hkv, g, S, hd)
    kf, vf = k.float(), v.float()
    of = out.float().reshape(B, hkv, g, S, hd)
    gf = dout.float().reshape(B, hkv, g, S, hd)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    scores.masked_fill_(~_mask(S, causal, window, q.device), -1e30)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse)
    del scores
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, gf)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gf, vf)
    delta = (gf * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window=None) -> torch.Tensor:
    """q: (B, Hq, hd), the query at position ``pos``; k_cache, v_cache:
    (B, Hkv, capacity, hd). The decode step's attention as the port's
    plain ``attn_decode`` computes it: float32 products over a float32
    copy of the whole cache, positions past ``pos`` (and, with a window,
    at least ``window`` back) masked, a float32 softmax, P rounded to the
    cache's dtype. Returns (B, Hq, hd) in q's dtype."""
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, 1, hd)
    scores = torch.einsum("bhgqd,bhcd->bhgqc", qg.float(),
                          k_cache.float()) * hd ** -0.5
    idx = torch.arange(k_cache.shape[2], device=q.device)
    mask = idx <= pos
    if window is not None:
        mask = mask & (pos - idx < window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqc,bhcd->bhgqd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
