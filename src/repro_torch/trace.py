"""Spans: the program's own timed intervals, on while a profiler records.

A span is a named interval of work with its counts as attributes: the
layer it belongs to starts its name (``Compute.``, ``Store.``,
``Write.``), its parent is the span under way on the same thread (or the
one named by ``parent=`` for work handed to another thread), and its
start and end are ``time.monotonic()`` seconds. The spans of one writer
step carry its ``epoch``.

Spans are recorded exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``), so the facility has
no switch of its own: outside a session ``span()`` returns one shared
no-op handle, which records nothing and reads no clock. Inside one each
span also opens a profiler range under its name, so it sits in the
profiler's host timeline beside the operators and kernels it issued.
The range is a host event only (``_RecordFunctionFast``):
``torch.profiler.record_function``'s user annotation would also draw a
range on the device's timeline, which a trace's device time would count
as work on the card.

Finished spans go to a bounded in-memory buffer (``CAPACITY`` entries;
the oldest are dropped first and counted by :func:`dropped`), read when
a run ends with :func:`spans`.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Callable, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

CAPACITY = 65_536


class Span:
    """A span under way, then its finished record: ``name``, ``id``,
    ``parent`` (an id or None), ``thread``, ``start`` and ``end``
    (``time.monotonic()``) and ``attrs``."""

    __slots__ = ("name", "id", "parent", "thread", "start", "end", "attrs",
                 "_rf")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.id = self.thread = self._rf = None
        self.start = self.end = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def timed(self, key: str, fn: Callable[..., Any], *args) -> Any:
        """``fn(*args)``, its host seconds kept as the attribute ``key``
        (for a read that blocks on the device)."""
        t = time.monotonic()
        out = fn(*args)
        self.attrs[key] = time.monotonic() - t
        return out

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1].id
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        stack.append(self)
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.monotonic()
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        _BUFFER.add(self)


class _Off:
    """The handle of every span while no profiler records."""

    id = None

    def set(self, **attrs) -> None:
        pass

    def timed(self, key: str, fn: Callable[..., Any], *args) -> Any:
        return fn(*args)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


class _Buffer:
    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(span)


OFF = _Off()
_BUFFER = _Buffer(CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, parent: Optional[int] = None, **attrs):
    """A context manager timing ``name``; it yields a handle with
    ``set(**attrs)`` and ``timed(key, fn, *args)``. ``parent`` is the id
    of the causing span when it runs on another thread."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, parent, attrs)


def spans(t0: Optional[float] = None,
          t1: Optional[float] = None) -> list[Span]:
    """The finished spans that ended in [t0, t1] (either end open when
    None), in the order they ended."""
    lo = float("-inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    with _BUFFER.lock:
        return [s for s in _BUFFER.records if lo <= s.end <= hi]


def dropped() -> int:
    """Finished spans the buffer's bound pushed out since the last
    :func:`clear`."""
    return _BUFFER.dropped


def clear() -> None:
    with _BUFFER.lock:
        _BUFFER.records.clear()
        _BUFFER.dropped = 0
