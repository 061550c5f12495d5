"""Replica-coherence data management — paper §2.2.

The paper's idea: partitioning is driven by *two* factors (load balance and
communication), replicas are created/migrated from observed access patterns,
writes keep replicas coherent, and obsolete replicas are collected.

Implementation: the *protocol* lives on the
control plane (this module — ownership, mirrors, invalidate-on-write,
access-stats-driven placement, GC); the *policy* output also drives the
ahead-of-time sharding of tensors in the compiled programs
(:class:`SharedTensorPolicy`, consumed by ``launch/sharding.py``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Any, Optional

import numpy as np

from repro_torch.core.versioned import Version, VersionedStore


# ----------------------------------------------------------------- coherence
@dataclasses.dataclass
class ReplicaMeta:
    owner: int
    mirrors: set[int] = dataclasses.field(default_factory=set)
    last_write: Version = Version(0, 0)
    # mirror -> version it last pulled (invalidate-on-write coherence)
    mirror_version: dict[int, Version] = dataclasses.field(default_factory=dict)
    last_used: dict[int, int] = dataclasses.field(default_factory=dict)


class ReplicaManager:
    """Owner/mirror coherence with access-stats-driven placement.

    Protocol:
      * every item has one *owner* node; writes commit at the owner and
        bump the item's version (a Paxos write in the real system; the
        single-writer discipline gives the same serializable order here);
      * mirrors serve reads; a write *invalidates* mirrors (they re-pull on
        next read -> coherence: a mirror never serves a value older than the
        invalidation);
      * ``rebalance()`` = the paper's scheduler: creates mirrors where remote
        read traffic is high, migrates ownership toward the heaviest writer,
        and keeps partitions load-balanced;
      * ``collect_obsolete()`` GCs mirrors unused for ``ttl`` rounds.
    """

    def __init__(self, n_nodes: int, *, mirror_threshold: int = 8,
                 ttl: int = 3, alpha_balance: float = 1.0,
                 beta_comm: float = 1.0):
        self.n_nodes = n_nodes
        self.meta: dict[Any, ReplicaMeta] = {}
        self.store = VersionedStore()          # committed (owner) versions
        self.remote_reads: Counter = Counter() # (node, item) -> count
        self.local_hits = 0
        self.remote_misses = 0
        self.invalidations = 0
        self.round = 0
        self.mirror_threshold = mirror_threshold
        self.ttl = ttl
        self.alpha = alpha_balance
        self.beta = beta_comm

    # -- placement ----------------------------------------------------------
    def add_item(self, item, owner: Optional[int] = None,
                 version: Optional[Version] = None, value: Any = None):
        version = Version(0, 0) if version is None else version
        owner = hash(item) % self.n_nodes if owner is None else owner
        self.meta[item] = ReplicaMeta(owner=owner, last_write=version)
        self.store.put(item, version, value)

    def holds(self, node: int, item) -> bool:
        m = self.meta[item]
        return node == m.owner or node in m.mirrors

    # -- protocol ------------------------------------------------------------
    def read(self, node: int, item, version: Optional[Version] = None):
        m = self.meta[item]
        m.last_used[node] = self.round
        if node == m.owner:
            self.local_hits += 1
            return self.store.get(item, version)
        if node in m.mirrors:
            pulled = m.mirror_version.get(node, Version(0, 0))
            if pulled >= m.last_write:
                self.local_hits += 1
                return self.store.get(item, version)
            # invalidated -> re-pull from owner (counts as one remote fetch)
            self.remote_misses += 1
            m.mirror_version[node] = m.last_write
            return self.store.get(item, version)
        self.remote_misses += 1
        self.remote_reads[(node, item)] += 1
        return self.store.get(item, version)

    def write(self, node: int, item, version: Version, value) -> None:
        m = self.meta[item]
        if node != m.owner:
            # forwarded to owner (single-writer serialization)
            self.remote_reads[(node, item)] += 1
        if version <= m.last_write:
            raise ValueError(f"stale write to {item!r}: {version} <= {m.last_write}")
        self.store.put(item, version, value)
        m.last_write = version
        # coherence: invalidate all mirrors
        self.invalidations += len(m.mirrors)

    # -- scheduler -----------------------------------------------------------
    def node_loads(self) -> list[int]:
        loads = [0] * self.n_nodes
        for m in self.meta.values():
            loads[m.owner] += 1
        return loads

    def cost(self) -> float:
        """Dynamic-equilibrium objective: alpha * imbalance + beta * traffic."""
        loads = self.node_loads()
        mean = sum(loads) / max(len(loads), 1)
        imbalance = sum((l - mean) ** 2 for l in loads)
        traffic = sum(self.remote_reads.values())
        return self.alpha * imbalance + self.beta * traffic

    def rebalance(self) -> dict:
        """One scheduler round: mirror hot remote items; migrate ownership to
        the dominant accessor when it will not break balance."""
        self.round += 1
        created, migrated = 0, 0
        loads = self.node_loads()
        mean = sum(loads) / max(len(loads), 1)
        per_item: dict[Any, Counter] = defaultdict(Counter)
        for (node, item), cnt in self.remote_reads.items():
            per_item[item][node] += cnt
        for item, counts in per_item.items():
            m = self.meta[item]
            node, cnt = counts.most_common(1)[0]
            if cnt >= self.mirror_threshold and node not in m.mirrors:
                # paper: 'this replica should be swapped to the requester'
                if loads[node] <= mean * 1.5:
                    m.owner, old = node, m.owner
                    m.mirrors.add(old)
                    m.mirror_version[old] = m.last_write
                    loads[node] += 1
                    loads[old] -= 1
                    migrated += 1
                else:
                    m.mirrors.add(node)
                    m.mirror_version[node] = m.last_write
                    created += 1
        self.remote_reads.clear()
        collected = self.collect_obsolete()
        return {"mirrors_created": created, "owners_migrated": migrated,
                "mirrors_collected": collected}

    def collect_obsolete(self) -> int:
        """GC mirrors unused for ttl rounds (paper: 'collect the obsolete
        replicas')."""
        collected = 0
        for m in self.meta.values():
            dead = {n for n in m.mirrors
                    if self.round - m.last_used.get(n, -10**9) > self.ttl}
            m.mirrors -= dead
            for n in dead:
                m.mirror_version.pop(n, None)
            collected += len(dead)
        return collected

    def stats(self) -> dict:
        return {
            "local_hits": self.local_hits,
            "remote_misses": self.remote_misses,
            "hit_rate": self.local_hits / max(self.local_hits + self.remote_misses, 1),
            "invalidations": self.invalidations,
            "cost": self.cost(),
        }


# ------------------------------------------------------- shard-range scheduler
@dataclasses.dataclass(frozen=True)
class SplitDecision:
    """One planner verdict: split ``shard``'s key range.

    ``load`` is the shard's observed load (mutations + weighted query
    touches, EWMA over recent epochs), ``mean_load`` the fleet mean at
    decision time; ``reason`` is a human-readable audit line surfaced in
    re-sharding summaries and server stats.
    """
    shard: int
    load: float
    mean_load: float
    reason: str


@dataclasses.dataclass(frozen=True)
class MergeDecision:
    """One planner verdict: fold ``removed`` back into its split sibling
    ``survivor`` (the inverse of :class:`SplitDecision`). ``load`` is the
    pair's combined observed load, ``mean_load`` the live-fleet mean at
    decision time."""
    survivor: int
    removed: int
    load: float
    mean_load: float
    reason: str


class ShardPlanner:
    """Access-pattern-driven re-sharding policy — the paper's scheduler rule
    (:meth:`ReplicaManager.rebalance`) lifted from per-item replicas to
    whole shard key ranges.

    ``rebalance`` mirrors/migrates single hot *items* from observed access
    counts; a graph shard is instead a hash *range* of destination keys, so
    the planner's unit of action is a range split: when one shard's
    observed load (the same dynamic-equilibrium imbalance term as
    :meth:`ReplicaManager.cost`) exceeds ``imbalance_threshold`` times the
    fleet mean, it proposes splitting that shard's range in half
    (consistent-hash style — only the migrating half moves). The mechanism
    (plan versioning, epoch-aligned migration) lives in
    ``repro_torch.graph.sharded``; this class is pure policy and holds no graph
    state, so it is trivially testable and swappable.

    The inverse lever, leaf coarsening, uses the same ledger: when a
    mergeable sibling pair's COMBINED load falls below
    ``merge_threshold`` times the live-fleet mean, :meth:`propose_merge`
    folds the pair back into one shard — reclaiming fan-out headroom the
    earlier split spent (which sibling pairs are legal comes from the
    routing plan's leaf tree, passed in as ``pairs``; policy stays
    graph-state-free).

    Guard rails: never propose beyond ``max_shards``; require
    ``min_epochs`` of observation since the last split (cooldown — stats
    reset on every split, so ``epochs_observed`` restarts) and ``min_load``
    total observed load (don't react to noise on an idle store).
    """

    def __init__(self, *, imbalance_threshold: float = 1.5,
                 min_load: float = 512.0, min_epochs: int = 2,
                 max_shards: int = 16, merge_threshold: float = 0.35):
        if imbalance_threshold <= 1.0:
            raise ValueError("imbalance_threshold must exceed 1.0 "
                             "(1.0 means perfectly balanced)")
        if not 0.0 < merge_threshold < 1.0:
            raise ValueError("merge_threshold must sit in (0, 1) "
                             "(a fraction of the fleet-mean load)")
        self.imbalance_threshold = imbalance_threshold
        self.min_load = min_load
        self.min_epochs = min_epochs
        self.max_shards = max_shards
        self.merge_threshold = merge_threshold

    @staticmethod
    def _live_mask(n: int, live) -> list[bool]:
        if live is None:
            return [True] * n
        mask = [bool(x) for x in live]
        if len(mask) != n:
            raise ValueError(f"live mask has {len(mask)} entries for "
                             f"{n} shards")
        return mask

    def propose(self, loads, *, epochs_observed: int,
                live=None) -> Optional[SplitDecision]:
        """One scheduler round: return the split to perform, or None.

        ``loads`` is the per-shard load vector (any sequence of floats);
        ``epochs_observed`` is how many sealed epochs the vector spans.
        ``live`` optionally masks out retired (merged-away) shards: they
        are never proposed and their permanently-zero loads are excluded
        from the mean. Pure function of its inputs — safe to call every
        epoch.
        """
        loads = [float(x) for x in loads]
        mask = self._live_mask(len(loads), live)
        alive = [i for i in range(len(loads)) if mask[i]]
        if len(alive) >= self.max_shards:
            return None
        if epochs_observed < self.min_epochs:
            return None
        total = sum(loads[i] for i in alive)
        if total < self.min_load:
            return None
        mean = total / len(alive)
        hot = max(alive, key=lambda i: loads[i])
        if loads[hot] <= self.imbalance_threshold * mean:
            return None
        return SplitDecision(
            shard=hot, load=loads[hot], mean_load=mean,
            reason=(f"shard {hot} load {loads[hot]:.0f} > "
                    f"{self.imbalance_threshold:.2f}x mean {mean:.1f} "
                    f"over {epochs_observed} epochs"))

    def propose_merge(self, loads, *, epochs_observed: int,
                      pairs, live=None) -> Optional[MergeDecision]:
        """Return the sibling merge to perform, or None.

        ``pairs`` is the legal ``(survivor, removed)`` sibling pairs from
        the routing plan (``RoutingPlan.mergeable_pairs()``). Picks the
        coldest pair, and only if its combined load is below
        ``merge_threshold`` x the live-fleet mean — the deliberate gap
        between that and ``imbalance_threshold`` is the hysteresis band
        that keeps a borderline shard from split/merge flapping. Same
        ``min_epochs`` / ``min_load`` noise guards as :meth:`propose`
        (an idle store looks uniformly cold; that is no reason to
        coarsen it)."""
        loads = [float(x) for x in loads]
        mask = self._live_mask(len(loads), live)
        alive = [i for i in range(len(loads)) if mask[i]]
        if epochs_observed < self.min_epochs or not alive:
            return None
        total = sum(loads[i] for i in alive)
        if total < self.min_load:
            return None
        mean = total / len(alive)
        best = None
        for survivor, removed in pairs:
            if not (mask[survivor] and mask[removed]):
                continue
            pair_load = loads[survivor] + loads[removed]
            if best is None or pair_load < best[0]:
                best = (pair_load, survivor, removed)
        if best is None:
            return None
        pair_load, survivor, removed = best
        if pair_load >= self.merge_threshold * mean:
            return None
        return MergeDecision(
            survivor=survivor, removed=removed, load=pair_load,
            mean_load=mean,
            reason=(f"siblings ({survivor}, {removed}) combined load "
                    f"{pair_load:.0f} < {self.merge_threshold:.2f}x mean "
                    f"{mean:.1f} over {epochs_observed} epochs"))


class MirrorPlanner:
    """Hot-vertex nomination policy for the replica plane: pick which
    vertices get their adjacency mirrored at the next publish.

    Deliberately a pure function of the access ledger's per-vertex heat
    vector — stable top-k (ties broken by vertex id), filtered by
    ``min_heat``, returned as sorted ids. No hysteresis state, so the
    resulting :class:`~repro_torch.graph.sharded.ReplicaPlan` — and therefore
    replica-first routing — is deterministic given (plan, ledger), which
    the property tests assert.
    """

    def __init__(self, *, mirror_k: int = 64, min_heat: float = 1.0):
        if mirror_k < 0:
            raise ValueError("mirror_k must be >= 0")
        self.mirror_k = mirror_k
        self.min_heat = min_heat

    def nominate(self, heat) -> np.ndarray:
        """Sorted int64 ids of the up-to-``mirror_k`` hottest vertices
        with heat >= ``min_heat``."""
        h = np.asarray(heat, np.float64).reshape(-1)
        if not self.mirror_k or not h.size:
            return np.zeros(0, np.int64)
        # stable argsort on -heat: equal heat resolves to the lower id
        order = np.argsort(-h, kind="stable")[:self.mirror_k]
        hot = order[h[order] >= self.min_heat]
        return np.sort(hot.astype(np.int64))


# ----------------------------------------------------- LM-side sharding policy
@dataclasses.dataclass
class TensorAccess:
    """Access statistics for one tensor in a compiled program."""
    name: str
    bytes_size: int            # full (unsharded) tensor bytes
    gather_bytes_per_step: int # collective traffic if sharded (from HLO)
    current: str               # "sharded" | "replicated"


class SharedTensorPolicy:
    """Replica-coherence policy for AOT-compiled programs: choose which
    tensors to replicate (mirror on every chip) vs shard, under a memory
    budget — the knapsack the paper's scheduler solves reactively, solved
    ahead-of-time from measured access patterns (HLO collective bytes)."""

    def __init__(self, hbm_budget_bytes: int):
        self.budget = hbm_budget_bytes

    def propose(self, tensors: list[TensorAccess], n_chips: int) -> dict:
        """Greedy: replicate tensors with the best traffic-saved per byte."""
        decisions = {}
        spent = 0
        ranked = sorted(
            (t for t in tensors if t.current == "sharded"),
            key=lambda t: t.gather_bytes_per_step / max(t.bytes_size, 1),
            reverse=True)
        for t in ranked:
            extra = t.bytes_size - t.bytes_size // n_chips
            if t.gather_bytes_per_step > t.bytes_size // n_chips and \
                    spent + extra <= self.budget:
                decisions[t.name] = "replicate"
                spent += extra
            else:
                decisions[t.name] = "keep-sharded"
        return {"decisions": decisions, "extra_bytes": spent}
