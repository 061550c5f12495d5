"""Versioned-snapshot checkpointing — the paper's §2.3.1 data model applied
to training state.

Every checkpoint is a version ``(epoch, step)`` in a :class:`VersionedStore`
directory; restore resolves ``snapshot(v) = max{v' <= v}`` — the paper's
rule — so "restart from where we were at step N" and "restart from latest"
are the same query. Old versions remain addressable until ``gc_below``
(obsolete-replica collection).

Leaves are gathered to the host and written whole. State is a nested
structure of dicts, lists and tuples whose leaves are tensors, arrays or
scalars; its flat ``.npz`` keys are the ones ``jax.tree_util`` gives the
same structure in the reference (dict keys sorted, ``/``-joined paths), so
either package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.versioned import Version, VersionedStore
from repro_torch.device import to_host


# threads reading a checkpoint's leaves
_READERS = min(8, os.cpu_count() or 1)


class CheckpointStructureError(ValueError):
    """The checkpoint on disk does not contain the requested state
    structure (missing leaves). Distinct from corruption/IO errors so
    callers probing for an alternative state shape (e.g. params-only vs
    full train state) can retry on THIS and re-raise everything else."""


def _leaves_with_paths(tree, path=()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in ``jax.tree_util``'s flattening order: dict
    entries by sorted key, list/tuple entries by index, ``None`` an empty
    subtree; keys are the path elements joined with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, item in enumerate(tree)
                for kv in _leaves_with_paths(item, path + (i,))]
    return [("/".join(str(p) for p in path), tree)]


def _unflatten(like, leaf_of: Callable[[str, Any], Any], path=()):
    """Rebuild ``like``'s structure with each leaf replaced by
    ``leaf_of(key, old_leaf)`` (dicts come back with sorted keys, as
    ``jax.tree_util.tree_unflatten`` builds them)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaf_of, path + (k,))
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(item, leaf_of, path + (i,))
                 for i, item in enumerate(like)]
        return type(like)(items)
    return leaf_of("/".join(str(p) for p in path), like)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: to_host(leaf) for key, leaf in _leaves_with_paths(tree)}


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.index = VersionedStore()
        self._load_index()

    def _manifest_path(self):
        return self.dir / "MANIFEST.json"

    def _load_index(self):
        mp = self._manifest_path()
        if mp.exists():
            for entry in json.loads(mp.read_text()):
                self.index.put("ckpt", Version(*entry["version"]),
                               entry["file"])

    def _write_atomic(self, fname: str, writer) -> None:
        """Crash-atomic file write: temp file in the same directory,
        flush + fsync, then ``os.replace`` over the final name (and an
        fsync of the directory so the rename itself is durable). A crash
        at any point leaves either the previous file or no file — never
        a torn one."""
        tmp = self.dir / (fname + ".tmp")
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dir / fname)
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _save_index(self):
        entries = [{"version": [v.epoch, v.number],
                    "file": self.index.get("ckpt", v)}
                   for v in self.index.versions("ckpt")]
        payload = json.dumps(entries, indent=1).encode()
        self._write_atomic("MANIFEST.json", lambda f: f.write(payload))

    # ------------------------------------------------------------------ API
    def save(self, state, *, epoch: int, step: int) -> Version:
        v = Version(epoch, step)
        fname = f"ckpt_e{epoch}_s{step}.npz"
        flat = _flatten(state)
        # data before manifest: the manifest must never name a checkpoint
        # that is not durably on disk (a crash between the two leaves an
        # unlisted .npz, which a later save's GC removes)
        self._write_atomic(fname, lambda f: np.savez(f, **flat))
        self.index.put("ckpt", v, fname)
        self._save_index()
        self._gc()
        return v

    def restore(self, like, version: Version | None = None):
        """Restore into the structure of ``like`` (a state pytree or its
        eval_shape). ``version=None`` -> latest; otherwise the paper's
        snapshot rule picks max{v' <= version}."""
        path = self.dir / self.index.get("ckpt", version)
        with np.load(path) as data:
            files = set(data.files)
        flat_like = _flatten(like)
        missing = set(flat_like) - files
        if missing:
            raise CheckpointStructureError(
                f"checkpoint missing leaves: {sorted(missing)[:4]}")

        def read(key):
            # a handle per read: the zip's CRC check and the copy out of
            # the file release the GIL, so the leaves are read in parallel
            with np.load(path) as data:
                return data[key]
        with ThreadPoolExecutor(max_workers=_READERS) as pool:
            arrays = dict(zip(flat_like, pool.map(read, flat_like)))

        def leaf_of(key, leaf):
            arr = arrays.pop(key)
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(
                    dtype=leaf.dtype, device=leaf.device)
            # the array is the file's own, fresh: no second copy when
            # its dtype is already the one asked for
            return arr.astype(leaf.dtype, copy=False) \
                if hasattr(leaf, "dtype") else arr

        return _unflatten(like, leaf_of)

    def versions(self):
        return self.index.versions("ckpt")

    def _gc(self):
        versions = self.index.versions("ckpt")
        if len(versions) <= self.keep:
            return
        cutoff = versions[-self.keep]
        for v in versions:
            if v < cutoff:
                fname = self.index.get("ckpt", v)
                (self.dir / fname).unlink(missing_ok=True)
        self.index.gc_below(cutoff)
        self._save_index()
