"""Lamport logical clocks (Leslie1978) — §2.3.3.2 event delivery.

Guarantee: if e1 → e2 (application-defined causal order) then T(e1) < T(e2).
Held against the reference by tests/test_torch_dataflow.py.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True, order=True)
class Stamp:
    """(time, node_id) — node_id breaks ties so stamps are a total order."""
    time: int
    node_id: int


class LamportClock:
    def __init__(self, node_id: int):
        self.node_id = node_id
        self._time = 0

    def tick(self) -> Stamp:
        """Local event."""
        self._time += 1
        return Stamp(self._time, self.node_id)

    def send(self) -> Stamp:
        """Stamp an outgoing message."""
        return self.tick()

    def receive(self, msg_stamp: Stamp) -> Stamp:
        """Merge an incoming stamp; the receive event is after the send."""
        self._time = max(self._time, msg_stamp.time) + 1
        return Stamp(self._time, self.node_id)


@dataclasses.dataclass(frozen=True)
class Event:
    stamp: Stamp
    kind: str
    payload: Any = None


class EventLog:
    """Collects events from many vertices and delivers them to observers in
    stamp order while preserving any registered causal `->` relation.

    Each program model registers its own ``happens_before(e1, e2)`` check
    (paper: "each program model ... needs to register its own function to
    check the causal-effect relation").
    """

    def __init__(self):
        self._events: list[Event] = []
        self._observers: dict[str, list[Callable[[Event], None]]] = {}
        self._relations: list[Callable[[Event, Event], Optional[bool]]] = []

    def register_relation(self, fn: Callable[[Event, Event], Optional[bool]]):
        self._relations.append(fn)

    def observe(self, kind: str, fn: Callable[[Event], None]):
        self._observers.setdefault(kind, []).append(fn)

    def record(self, event: Event):
        self._events.append(event)

    def happens_before(self, e1: Event, e2: Event) -> bool:
        for rel in self._relations:
            r = rel(e1, e2)
            if r is not None:
                return r
        return False

    def deliver(self) -> list[Event]:
        """Deliver all recorded events in total (stamp) order. Because every
        vertex stamps with a Lamport clock, stamp order extends every causal
        order: e1 -> e2 implies T(e1) < T(e2) implies delivery order."""
        order = sorted(self._events, key=lambda e: e.stamp)
        for ev in order:
            for fn in self._observers.get(ev.kind, ()):
                fn(ev)
        delivered, self._events = order, []
        return delivered

    def check_causal_consistency(self, delivered: list[Event]) -> bool:
        """Validate the delivery respected every registered -> relation."""
        for i, j in itertools.combinations(range(len(delivered)), 2):
            if self.happens_before(delivered[j], delivered[i]):
                return False
        return True
