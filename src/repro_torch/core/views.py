"""Distributed views — paper §2.3.2.

A distributed view is an immutable dataset *expressed by the computation from
which it is generated* (like RDD lineage). Fault tolerance = re-running the
lineage path. Views are how online and offline computations share data: the
online side reads materialized views; the offline side (re)builds them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core.versioned import Version


@dataclasses.dataclass(frozen=True)
class ViewSpec:
    name: str
    compute: Callable[..., Any]           # parents' values -> value
    parents: tuple["View", ...] = ()
    snapshot: Optional[Version] = None    # pin to a graph snapshot


class View:
    """Immutable, lineage-carrying, lazily-materialized dataset."""

    def __init__(self, spec: ViewSpec):
        self.spec = spec
        self._value: Any = None
        self._materialized = False

    @staticmethod
    def source(name: str, produce: Callable[[], Any],
               snapshot: Optional[Version] = None) -> "View":
        return View(ViewSpec(name, lambda: produce(), (), snapshot))

    def map(self, name: str, fn: Callable[[Any], Any]) -> "View":
        return View(ViewSpec(name, fn, (self,), self.spec.snapshot))

    @staticmethod
    def join(name: str, fn: Callable[..., Any], *parents: "View") -> "View":
        snap = max((p.spec.snapshot for p in parents
                    if p.spec.snapshot is not None), default=None)
        return View(ViewSpec(name, fn, tuple(parents), snap))

    def value(self):
        if not self._materialized:
            args = [p.value() for p in self.spec.parents]
            self._value = self.spec.compute(*args)
            self._materialized = True
        return self._value

    # ---------------------------------------------------------- fault path
    def invalidate(self, *, recursive: bool = False) -> None:
        """Simulate loss of the materialized partition (node failure)."""
        self._value, self._materialized = None, False
        if recursive:
            for p in self.spec.parents:
                p.invalidate(recursive=True)

    def recover(self):
        """Recompute along the lineage path (paper: 'trace back its lineage
        and redo the computations')."""
        return self.value()

    def lineage(self) -> list[str]:
        out: list[str] = []

        def walk(v: "View"):
            for p in v.spec.parents:
                walk(p)
            out.append(v.spec.name)
        walk(self)
        return out
