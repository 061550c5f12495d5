"""Protocol dataflow — paper §2.3.3.

A directed graph of *stateful* vertices. Computing starts at an **ingress**
vertex (encapsulates external input into messages per a protocol) and ends at
an **egress** vertex (decapsulates to an external consumer). Each internal
vertex has input queues and output queues plus two schedulers:

* the **input scheduler** picks which queued messages to process next
  (application-specific scheduling — e.g. a priority queue turns label-
  correcting SSSP into Dijkstra);
* the **output scheduler** reorders/coalesces outgoing messages
  (communication optimization — e.g. combining messages to the same target,
  Trinity-style hub buffering).

A **protocol** = (message format, vertex semantics). Different programming
models (Pregel, edge-centric, MapReduce, timely-style epochs) are different
protocols over the same runtime; they compose in one dataflow (paper Fig 6).
Control flow is data-dependent — the runtime loop below is only an executor;
no central scheduler is needed for correctness (paper's scale-out argument).

Event delivery uses Lamport clocks (``core.clock``): every vertex stamps
sends/receives, so delivery in stamp order preserves every causal relation.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Any, Callable, Iterable, Optional

from repro_torch.core.clock import Event, EventLog, LamportClock, Stamp


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass(frozen=True)
class Protocol:
    """Message format + vertex semantics contract."""
    name: str
    validate: Callable[[Any], bool] = lambda payload: True
    # application-defined causal relation for event delivery (optional)
    happens_before: Optional[Callable[[Event, Event], Optional[bool]]] = None


@dataclasses.dataclass(frozen=True)
class Message:
    stamp: Stamp
    epoch: int
    payload: Any


# ---------------------------------------------------------------- schedulers
class FIFOScheduler:
    """Default input scheduler: drain in arrival order."""

    def select(self, queue: deque, budget: int) -> list[Message]:
        out = []
        while queue and len(out) < budget:
            out.append(queue.popleft())
        return out


class PriorityScheduler:
    """Application-specific input scheduling (paper: Dijkstra via priority
    queue). ``key`` maps a payload to its priority (smaller = first)."""

    def __init__(self, key: Callable[[Any], float]):
        self.key = key
        self._heap: list[tuple[float, int, Message]] = []
        self._n = 0

    def select(self, queue: deque, budget: int) -> list[Message]:
        while queue:
            m = queue.popleft()
            heapq.heappush(self._heap, (self.key(m.payload), self._n, m))
            self._n += 1
        out = []
        while self._heap and len(out) < budget:
            out.append(heapq.heappop(self._heap)[2])
        return out


class IdentityOutput:
    def emit(self, msgs: list[tuple[str, Any]]) -> list[tuple[str, Any]]:
        return msgs


class CoalescingOutput:
    """Combine messages with the same coalescing key before sending
    (message-scheduling / communication optimization, §2.3.3.2)."""

    def __init__(self, key: Callable[[Any], Any], combine: Callable[[Any, Any], Any]):
        self.key = key
        self.combine = combine

    def emit(self, msgs: list[tuple[str, Any]]) -> list[tuple[str, Any]]:
        merged: dict[tuple[str, Any], Any] = {}
        order: list[tuple[str, Any]] = []
        for port, payload in msgs:
            k = (port, self.key(payload))
            if k in merged:
                merged[k] = self.combine(merged[k], payload)
            else:
                merged[k] = payload
                order.append(k)
        return [(port, merged[(port, k)]) for port, k in order]


# ------------------------------------------------------------------ vertices
class Vertex:
    """A stateful protocol-dataflow vertex.

    Subclasses (or the ``fn`` constructor arg) implement the protocol's
    semantics: ``fn(vertex, port, payloads) -> iterable of (out_port,
    payload)``. State lives on the instance (``self.state``).
    """

    def __init__(self, name: str, protocol: Protocol,
                 fn: Optional[Callable] = None, *, state: Any = None,
                 input_scheduler=None, output_scheduler=None,
                 budget: int = 1 << 30):
        self.name = name
        self.protocol = protocol
        self.fn = fn
        self.state = state
        self.inputs: dict[str, deque] = {}
        self.out_edges: dict[str, list[tuple["Vertex", str]]] = {}
        self.input_scheduler = input_scheduler or FIFOScheduler()
        self.output_scheduler = output_scheduler or IdentityOutput()
        self.budget = budget
        self.clock: Optional[LamportClock] = None   # set by Dataflow
        self.dataflow: Optional["Dataflow"] = None

    # -- wiring ------------------------------------------------------------
    def in_port(self, port: str) -> deque:
        return self.inputs.setdefault(port, deque())

    def connect(self, out_port: str, dst: "Vertex", dst_port: str = "in"):
        dst.in_port(dst_port)
        self.out_edges.setdefault(out_port, []).append((dst, dst_port))
        return dst

    # -- execution ---------------------------------------------------------
    def has_pending(self) -> bool:
        if any(q for q in self.inputs.values()):
            return True
        heap = getattr(self.input_scheduler, "_heap", None)
        return bool(heap)

    def on_receive(self, port: str, payloads: list[Any]) -> Iterable[tuple[str, Any]]:
        if self.fn is None:
            raise NotImplementedError(f"{self.name} has no semantics fn")
        return self.fn(self, port, payloads) or ()

    def deliver(self, port: str, msg: Message):
        self.clock.receive(msg.stamp)
        self.in_port(port).append(msg)

    def step(self) -> int:
        """Process up to ``budget`` messages; emit results. Returns number of
        messages processed."""
        processed = 0
        for port, queue in list(self.inputs.items()):
            batch = self.input_scheduler.select(queue, self.budget)
            if not batch:
                continue
            processed += len(batch)
            epoch = max(m.epoch for m in batch)
            outs = list(self.on_receive(port, [m.payload for m in batch]))
            self._emit(outs, epoch)
        return processed

    def _emit(self, outs: list[tuple[str, Any]], epoch: int):
        for out_port, payload in self.output_scheduler.emit(outs):
            if not self.protocol.validate(payload):
                raise ValueError(
                    f"{self.name}: payload violates protocol "
                    f"{self.protocol.name}: {payload!r}")
            for dst, dst_port in self.out_edges.get(out_port, ()):
                stamp = self.clock.send()
                self.dataflow.events.record(
                    Event(stamp, "send",
                          {"src": self.name, "dst": dst.name, "epoch": epoch}))
                dst.deliver(dst_port, Message(stamp, epoch, payload))

    def emit_event(self, kind: str, payload: Any = None):
        """User-defined events (paper: 'allows the user to define any kind
        of event')."""
        self.dataflow.events.record(Event(self.clock.tick(), kind, payload))


class Ingress(Vertex):
    """Receives input from an external source and encapsulates it into
    messages according to the protocol (``encode`` is the encapsulation)."""

    def __init__(self, name: str, protocol: Protocol,
                 encode: Optional[Callable[[Any], Any]] = None):
        super().__init__(name, protocol)
        self.encode = encode or (lambda payload: payload)

    def push(self, payloads: Iterable[Any], epoch: int = 0,
             out_port: str = "out"):
        outs = [(out_port, self.encode(p)) for p in payloads]
        self._emit(outs, epoch)


class Egress(Vertex):
    """Decapsulates messages and hands data to an external consumer."""

    def __init__(self, name: str, protocol: Protocol,
                 consumer: Callable[[Any], None]):
        super().__init__(name, protocol, fn=self._consume)
        self.consumer = consumer
        self.received: list[Any] = []

    def _consume(self, _self, port, payloads):
        for p in payloads:
            self.received.append(p)
            self.consumer(p)
        return ()


# ------------------------------------------------------------------ dataflow
class Dataflow:
    """The directed graph + executor + event log."""

    def __init__(self, name: str = "dataflow"):
        self.name = name
        self.vertices: list[Vertex] = []
        self.events = EventLog()
        self._next_id = 0

    def add(self, vertex: Vertex) -> Vertex:
        vertex.clock = LamportClock(self._next_id)
        vertex.dataflow = self
        self._next_id += 1
        self.vertices.append(vertex)
        if vertex.protocol.happens_before is not None:
            self.events.register_relation(vertex.protocol.happens_before)
        return vertex

    def run_until_quiescent(self, max_rounds: int = 10_000) -> int:
        """Data-dependent control flow: keep stepping vertices that have
        pending input. Returns number of rounds."""
        for round_no in range(max_rounds):
            work = 0
            for v in self.vertices:
                if v.has_pending():
                    work += v.step()
            if work == 0:
                return round_no
        raise RuntimeError(f"{self.name}: not quiescent after {max_rounds} rounds")

    def deliver_events(self) -> list[Event]:
        delivered = self.events.deliver()
        assert self.events.check_causal_consistency(delivered)
        return delivered
