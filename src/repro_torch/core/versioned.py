"""Versioned data sets and snapshots — paper §2.3.1 (Fig 3).

Every data item carries versions ``(epoch, version)``; a mutation creates a
new version. A snapshot is resolved with the paper's rule::

    snapshot(v) = { d(i_v) },   i_v = max { v' <= v }

Two implementations share the rule:

* :class:`VersionedStore` — host-side multi-version KV store (control plane:
  checkpoints, schemas, replica directory entries).
* :func:`resolve_versions` / :class:`VersionedArray` — tensor data plane:
  a vectorized count resolves whole columns of versioned items at once;
  ``VersionedArray.read_snapshot`` goes through the ``snapshot_resolve``
  kernel on a CUDA device.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True, order=True)
class Version:
    """Paper Fig 3(a): epoch identifier + version number within the epoch."""
    epoch: int
    number: int

    def pack(self) -> int:
        return (self.epoch << 32) | self.number

    @staticmethod
    def unpack(packed: int) -> "Version":
        return Version(packed >> 32, packed & 0xFFFFFFFF)


ZERO = Version(0, 0)

# Data-plane packing: int32-safe, the width the stamp tensors and kernels use.
# Host-side control plane uses the full 64-bit pack(); the graph store keeps
# its created/deleted/v_created stamp arrays in THIS packing natively so the
# kernel path never re-packs on the host. int32 max is reserved as the
# 'never' sentinel, so the largest valid stamp is int32 max - 1.
PACK_BITS = 20
EPOCH_LIMIT = 1 << (31 - PACK_BITS)      # epochs representable in int32
NUMBER_LIMIT = 1 << PACK_BITS            # version numbers per epoch
PACK32_NEVER = np.iinfo(np.int32).max    # 'never created/deleted' sentinel


def pack32(v: Version) -> int:
    assert v.epoch < EPOCH_LIMIT and v.number < NUMBER_LIMIT, v
    return (v.epoch << PACK_BITS) | v.number


def pack32_checked(v: Version) -> int:
    """int32 data-plane packing of a *stamp* about to be stored.

    Raises ``ValueError`` (not an assert — overflow would silently corrupt
    every later snapshot mask) when the version exceeds the packing, or
    collides with the reserved ``PACK32_NEVER`` sentinel. The graph store
    calls this once per ``apply`` — the single overflow check of the
    int32-native stamp plane.
    """
    packed = (v.epoch << PACK_BITS) | v.number
    if (v.epoch >= EPOCH_LIMIT or v.number >= NUMBER_LIMIT
            or packed >= PACK32_NEVER):
        raise ValueError(
            "version stamp exceeds int32 data-plane packing "
            f"(epoch < {EPOCH_LIMIT}, number < {NUMBER_LIMIT}, "
            f"int32 max reserved): {v}")
    return packed


def unpack32(packed: int) -> Version:
    """Inverse of :func:`pack32` (valid for checked stamps, which never
    collide with the sentinel)."""
    return Version(packed >> PACK_BITS, packed & (NUMBER_LIMIT - 1))


def pack32_clamped(v: Version) -> int:
    """int32 packing of a *query* version, clamped into the packable range.

    Stored stamps are range-checked at apply time, but a query may name any
    version (e.g. a far-future snapshot). Clamping each field to its limit
    preserves the ordering against every valid stamp: an in-range epoch
    with an overflowing number clamps to that epoch's last slot (sees all
    of the epoch, none of the next); an overflowing epoch clamps to the
    largest valid stamp (sees everything, never the sentinel).
    """
    packed = (min(v.epoch, EPOCH_LIMIT - 1) << PACK_BITS) \
        | min(v.number, NUMBER_LIMIT - 1)
    return min(packed, PACK32_NEVER - 1)


class VersionedStore:
    """Multi-version key-value items (paper Fig 3(b))."""

    def __init__(self):
        # key -> (sorted list of packed versions, list of values)
        self._items: dict[Any, tuple[list[int], list[Any]]] = {}

    def put(self, key, version: Version, value) -> None:
        vs, vals = self._items.setdefault(key, ([], []))
        packed = version.pack()
        idx = bisect.bisect_left(vs, packed)
        if idx < len(vs) and vs[idx] == packed:
            raise ValueError(f"version {version} of {key!r} already written "
                             "(versions are immutable)")
        vs.insert(idx, packed)
        vals.insert(idx, value)

    def get(self, key, version: Optional[Version] = None):
        """Paper's snapshot rule: value at max version <= requested."""
        if key not in self._items:
            raise KeyError(key)
        vs, vals = self._items[key]
        if version is None:
            return vals[-1]
        idx = bisect.bisect_right(vs, version.pack()) - 1
        if idx < 0:
            raise KeyError(f"{key!r} has no version <= {version}")
        return vals[idx]

    def versions(self, key) -> list[Version]:
        return [Version.unpack(p) for p in self._items.get(key, ([], []))[0]]

    def keys(self) -> Iterable:
        return self._items.keys()

    def snapshot(self, version: Version) -> dict:
        """Materialize {key: d(i_v)} for all keys with a version <= v."""
        out = {}
        for key in self._items:
            try:
                out[key] = self.get(key, version)
            except KeyError:
                pass
        return out

    def gc_below(self, version: Version) -> int:
        """Collect obsolete versions: keep, per key, only the newest version
        <= v (still addressable by snapshot(v)) plus everything > v.
        Returns number of dropped versions (paper §2.2 'obsolete replicas')."""
        dropped = 0
        packed = version.pack()
        for key, (vs, vals) in self._items.items():
            idx = bisect.bisect_right(vs, packed) - 1
            if idx > 0:
                del vs[:idx]
                del vals[:idx]
                dropped += idx
        return dropped


def resolve_versions(item_versions, query_version):
    """Vectorized snapshot rule over a column of packed versions.

    item_versions: (N, K) int32 tensor of packed versions per item, sorted
    ascending along K, padded with int32 max (``PACK32_NEVER``) for unused
    slots. Returns (N,) int32 index i_v into K of max version <= query, or
    -1 if none.
    """
    item_versions = torch.as_tensor(item_versions)
    # count of versions <= q, minus one (the row is ascending)
    return ((item_versions <= int(query_version)).sum(dim=-1)
            .to(torch.int32) - 1)


class VersionedArray:
    """A fixed-capacity multi-version array column (tensor data plane).

    values: (N, K) — K version slots per item; versions: (N, K) packed,
    ascending, MAX-padded. Snapshot read = one ``snapshot_resolve`` pass
    (the hand-written kernel on a CUDA device, its plain version on the
    CPU).
    """

    MAXV = np.iinfo(np.int32).max

    def __init__(self, n_items: int, capacity: int, dtype=torch.float32, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.values = torch.zeros((n_items, capacity), dtype=dtype,
                                  device=self.device)
        self.versions = torch.full((n_items, capacity), self.MAXV,
                                   dtype=torch.int32, device=self.device)
        self.fill = torch.zeros((n_items,), dtype=torch.int32,
                                device=self.device)

    def write(self, item_ids, version: Version, new_values):
        """Append a new version for the given items (one mutation batch)."""
        ids = torch.as_tensor(item_ids, device=self.device).long()
        slots = self.fill[ids].long()
        self.values[ids, slots] = torch.as_tensor(
            new_values, dtype=self.values.dtype, device=self.device)
        self.versions[ids, slots] = pack32(version)
        self.fill.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        return self

    def read_snapshot(self, version: Version, default=0):
        vals, idx = ops.snapshot_resolve(self.versions, self.values,
                                         pack32(version))
        return torch.where(idx >= 0, vals, default)
