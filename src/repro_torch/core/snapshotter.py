"""Asynchronous global-snapshot progress tracking — paper §2.3.1 (Fig 4).

Kineograph uses a *central* snapshoter: all mutations of epoch e+1 wait until
the global snapshot of epoch e is sealed. The paper's improvement (which we
implement) is *no-wait dispatch*: the ingest node only checks that the target
data node's **local** snapshot frontier covers the previous epochs; mutations
from different epochs dispatch concurrently. The global snapshot frontier is
the min over local frontiers and advances in the background (in the real
system via a Paxos quorum; here a deterministic state machine with the same
external guarantees — see DESIGN.md §2 'Paxos').

Invariants (property-tested):
  * the global frontier is monotone non-decreasing,
  * a computation scheduled on snapshot v only launches once global >= v,
  * dispatch never blocks on the *global* frontier (only on the target
    node's local frontier).

This is layer 2 of the pipeline mapped in ``docs/ARCHITECTURE.md``
(ingest -> seal -> view -> query); ``graph/sharded.py`` stacks the
sharded graph store on these primitives via the ``on_seal`` hook.

Thread-safety: none of these classes lock internally — the serving layer
serializes every touch (see ``launch/serve_graph.py``); the benchmark and
tests are single-threaded. The sharded store's parallel apply
plane (``ShardedDynamicGraph.seal_epoch`` with ``parallel_apply > 1``)
may run ``DataNode.seal_epoch`` for *different* nodes concurrently: a
node's pending maps, frontier, and ``on_seal`` state are touched only by
the one thread sealing that node, while ingest-side state (``IngestNode``
queues, the coordinator) stays on the calling thread between rounds.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Mutation:
    key: int          # routing key (e.g. destination vertex id)
    epoch: int
    payload: object = None


class DataNode:
    """Holds a shard of the data; seals local snapshots per epoch.

    ``on_seal(epoch, payloads)`` (optional) is the hook that turns the node
    from a progress tracker into a real store: it fires inside
    :meth:`seal_epoch` with the payload arrays received for that epoch, in
    arrival order — the sharded graph store applies its slice of each
    mutation batch there, so the local snapshot and the shard's state seal
    atomically.
    """

    def __init__(self, node_id: int,
                 on_seal: Callable[[int, list], None] | None = None):
        self.node_id = node_id
        self.on_seal = on_seal
        self.pending: dict[int, list[Mutation]] = defaultdict(list)
        self.pending_batches: dict[int, list[np.ndarray]] = defaultdict(list)
        self.pending_payloads: dict[int, list] = defaultdict(list)
        self.local_frontier = -1          # highest epoch locally sealed
        self.applied: list[Mutation] = []
        # batched ingress is counted, not retained: the payloads were
        # handed to on_seal and the keys would otherwise pin O(stream)
        # memory per node
        self.applied_batch_count = 0

    def receive(self, mut: Mutation) -> None:
        """Scalar ingress: queue one mutation for its epoch's seal."""
        self.pending[mut.epoch].append(mut)

    def receive_batch(self, epoch: int, keys: np.ndarray,
                      payload=None) -> None:
        """Vectorized ingress: a whole key array for one epoch at once.
        ``payload`` is an optional object riding along with the keys —
        usually an array-like with the same leading dimension, but opaque
        to this layer (the sharded store's single-shard passthrough sends
        whole ``MutationBatch`` objects) — handed to ``on_seal`` when the
        epoch seals."""
        self.pending_batches[epoch].append(np.asarray(keys))
        if payload is not None:
            self.pending_payloads[epoch].append(payload)

    def seal_epoch(self, epoch: int) -> None:
        """Define the local snapshot for `epoch` (applies its mutations).

        ``on_seal`` runs first and the seal only commits (pending drained,
        frontier advanced) if it returns: a failing hook — e.g. a shard
        hitting capacity — leaves the epoch pending and re-sealable instead
        of silently destroying its mutations.

        Raises:
            ValueError: ``epoch`` is not ``local_frontier + 1`` (local
                snapshots seal strictly in order).
        """
        if epoch != self.local_frontier + 1:
            raise ValueError(
                f"node {self.node_id}: seal {epoch} out of order "
                f"(local frontier {self.local_frontier})")
        if self.on_seal is not None:
            self.on_seal(epoch, self.pending_payloads.get(epoch, []))
        self.applied.extend(self.pending.pop(epoch, []))
        self.applied_batch_count += sum(
            len(a) for a in self.pending_batches.pop(epoch, []))
        self.pending_payloads.pop(epoch, None)
        self.local_frontier = epoch

    @property
    def applied_count(self) -> int:
        return len(self.applied) + self.applied_batch_count


class SnapshotCoordinator:
    """Tracks the global frontier = min(local frontiers); runs callbacks of
    computations whose snapshot dependency becomes available."""

    def __init__(self, nodes: list[DataNode]):
        self.nodes = nodes
        self._global = -1
        self._waiting: list[tuple[int, Callable[[], None]]] = []
        self._history: list[int] = []
        self._subscribers: list[Callable[[int], None]] = []

    def subscribe(self, fn: Callable[[int], None]) -> None:
        """Register a seal-notification callback: ``fn(new_frontier)`` fires
        from :meth:`advance` every time the global frontier actually moves
        (an epoch became globally sealed). Unlike
        :meth:`schedule_on_snapshot` — one-shot, per-epoch — a subscriber is
        permanent: the online serving layer uses it to learn that a newer
        consistent snapshot exists without polling."""
        self._subscribers.append(fn)

    @property
    def global_frontier(self) -> int:
        """Highest epoch sealed on EVERY node (-1 before the first)."""
        return self._global

    def advance(self) -> int:
        """Recompute the global frontier (min over local frontiers), run
        any newly-eligible scheduled computations, and notify subscribers
        if it moved. Returns the (possibly unchanged) frontier. Raises
        ``AssertionError`` if the frontier would regress — impossible
        unless a node's local frontier was rolled back externally."""
        new = min(n.local_frontier for n in self.nodes)
        if new < self._global:
            raise AssertionError("global snapshot frontier went backwards")
        moved = new > self._global
        self._global = new
        self._history.append(new)
        still = []
        for epoch, cb in self._waiting:
            if epoch <= self._global:
                cb()
            else:
                still.append((epoch, cb))
        self._waiting = still
        if moved:
            for fn in self._subscribers:
                fn(self._global)
        return self._global

    def schedule_on_snapshot(self, epoch: int, fn: Callable[[], None]):
        """Paper: 'the computing is launched until all the global snapshots
        it will process become available'."""
        if epoch <= self._global:
            fn()
        else:
            self._waiting.append((epoch, fn))


class IngestNode:
    """Dispatches mutations asynchronously (paper's no-wait rule).

    ``route`` maps a routing key to a node index; the sharded store swaps
    it at a re-sharding cutover (``RoutingPlan.assign`` of the successor
    plan), which is safe because cutover requires quiescence — nothing
    in-flight is ever re-routed. Ineligible mutations park in ``blocked``
    / ``blocked_batches`` until :meth:`retry_blocked` /
    :meth:`retry_blocked_batches` re-dispatches them.
    """

    def __init__(self, nodes: list[DataNode], route: Callable[[int], int]):
        self.nodes = nodes
        self.route = route
        self.blocked: list[Mutation] = []
        self.blocked_batches: list[tuple[int, np.ndarray, object]] = []
        self.dispatched = 0

    def dispatch(self, mut: Mutation) -> bool:
        """Dispatch if the target node's LOCAL snapshot of all previous
        epochs is defined; never consults the global frontier."""
        node = self.nodes[self.route(mut.key)]
        if node.local_frontier >= mut.epoch - 1:
            node.receive(mut)
            self.dispatched += 1
            return True
        self.blocked.append(mut)
        return False

    def retry_blocked(self) -> int:
        """Re-dispatch every parked scalar mutation; returns how many
        landed (the rest park again)."""
        muts, self.blocked = self.blocked, []
        return sum(self.dispatch(m) for m in muts)

    def dispatch_batch(self, keys: np.ndarray, epochs: np.ndarray,
                       payload=None, *,
                       node_ids: np.ndarray | None = None) -> int:
        """Vectorized no-wait dispatch: route a whole mutation array at once.

        Applies the same per-mutation rule as :meth:`dispatch` (target
        node's LOCAL frontier must cover prior epochs), but routing,
        eligibility, and (node, epoch) grouping are NumPy ops — one Python
        step per distinct (node, epoch) group instead of per mutation.
        Ineligible mutations are parked in ``blocked_batches``. Returns the
        number dispatched now.

        ``payload`` optionally carries per-mutation data (any array-like
        supporting fancy row indexing, same leading dimension as ``keys``);
        each (node, epoch) group's payload slice is delivered with its keys
        and surfaced to the node's ``on_seal`` hook at seal time. Grouping
        is stable, so a group's payload rows keep their original order.

        ``node_ids`` overrides ``route`` with an explicit per-mutation
        target array (same shape as ``keys``). The re-sharding migration
        uses this: its delete half must land on the *source* shard even
        though the migrating keys already route to the target under the
        newly-activated plan. Eligibility, parking, and seal semantics are
        unchanged — an overridden mutation is still an ordinary payload.
        Parked slices are re-dispatched through ``route``, so overrides
        require eligible targets (the migration's quiescence precondition
        guarantees this).
        """
        keys = np.asarray(keys)
        epochs = np.asarray(epochs)
        if keys.size == 0:
            return 0
        if node_ids is not None:
            node_ids = np.asarray(node_ids)
            if node_ids.shape != keys.shape:
                raise ValueError("node_ids must match keys elementwise")
        else:
            try:
                node_ids = np.asarray(self.route(keys))
                if node_ids.shape != keys.shape:
                    raise TypeError
            except Exception:  # route not vectorizable — apply elementwise
                node_ids = np.asarray([self.route(int(k)) for k in keys],
                                      np.int64)
        frontiers = np.asarray([n.local_frontier for n in self.nodes])
        ok = frontiers[node_ids] >= epochs - 1
        # steady-state fast path: one epoch, every node caught up — group
        # by node with a single stable sort, then reorder keys/payload
        # ONCE and hand each node a contiguous (zero-copy) slice instead
        # of a fancy-indexed gather per group
        if ok.all() and (epochs == epochs[0]).all():
            epoch = int(epochs[0])
            order = np.argsort(node_ids, kind="stable")
            sorted_nodes = node_ids[order]
            keys_s = keys[order]
            payload_s = payload[order] if payload is not None else None
            starts = np.flatnonzero(
                np.r_[True, sorted_nodes[1:] != sorted_nodes[:-1]])
            bounds = np.r_[starts, len(order)]
            for a, b in zip(bounds[:-1], bounds[1:], strict=True):
                self.nodes[int(sorted_nodes[a])].receive_batch(
                    epoch, keys_s[a:b],
                    payload_s[a:b] if payload_s is not None else None)
            self.dispatched += len(keys)
            return len(keys)
        for eligible, sink in ((ok, True), (~ok, False)):
            idx = np.flatnonzero(eligible)
            if not idx.size:
                continue
            order = idx[np.lexsort((epochs[idx], node_ids[idx]))]
            group = node_ids[order].astype(np.int64) << 32 | epochs[order]
            starts = np.flatnonzero(np.r_[True, group[1:] != group[:-1]])
            bounds = np.r_[starts, len(order)]
            for a, b in zip(bounds[:-1], bounds[1:], strict=True):
                rows = order[a:b]
                epoch = int(epochs[rows[0]])
                rows_payload = payload[rows] if payload is not None else None
                if sink:
                    self.nodes[int(node_ids[rows[0]])].receive_batch(
                        epoch, keys[rows], rows_payload)
                else:
                    self.blocked_batches.append(
                        (epoch, keys[rows], rows_payload))
        n_ok = int(ok.sum())
        self.dispatched += n_ok
        return n_ok

    def retry_blocked_batches(self) -> int:
        """Re-dispatch every parked batch slice (through ``route``);
        returns how many mutations landed (the rest park again)."""
        batches, self.blocked_batches = self.blocked_batches, []
        done = 0
        for epoch, keys, payload in batches:
            done += self.dispatch_batch(keys, np.full(len(keys), epoch),
                                        payload)
        return done
