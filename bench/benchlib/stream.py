"""The edge stream every graph cell feeds: Graph500 Kronecker edges in blocks.

The generator is the Graph500 specification's (section 3, the reference
``kronecker_generator.m``): each of ``scale`` levels draws the source
bit with probability ``1 - (A + B)`` and the destination bit with
``C / (1 - (A + B))`` after a set source bit, ``B / (A + B)`` after a
clear one; vertex labels are then permuted by one permutation, drawn
from the configuration's ``label_seed`` (the same for every run seed).
Self loops and repeated edges stay, as the specification leaves them.

The stream is cut into blocks of ``block_edges`` edges, and block ``b`` is
drawn from its own generator seeded by ``(seed, b)``, so any block, and so
any epoch, can be made again alone. The base graph is the first
``base_blocks`` blocks; stream epoch ``t`` (1-based) adds the next
``epoch_blocks`` blocks and deletes the oldest ``epoch_blocks`` live ones,
so the live edge count stays at the base's. Both the program and the
reference are handed these same blocks.
"""
from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


def mix_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for sub-stream ``stream`` of ``seed``
    (splitmix64 of the pair; any integer seed, negative or past 32 bits)."""
    x = ((seed & _MASK64) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


# sub-stream ids: the label permutation, then one per block
_PERM_STREAM = 1
_BLOCK_STREAM0 = 1 << 20


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the blocks go: ``base_blocks`` blocks in ``base_epochs``
    equal epochs, then ``epoch_blocks`` added and as many deleted per
    stream epoch."""
    base_blocks: int
    base_epochs: int
    epoch_blocks: int

    def epoch_of_stream(self, t: int) -> int:
        """Store epoch of stream epoch ``t`` (1-based)."""
        return self.base_epochs - 1 + t

    def live_blocks(self, epoch: int) -> range:
        """Blocks live once store epoch ``epoch`` is sealed."""
        if epoch < self.base_epochs:
            per = self.base_blocks // self.base_epochs
            return range(0, per * (epoch + 1))
        t = epoch - self.base_epochs + 1
        lo = t * self.epoch_blocks
        return range(lo, lo + self.base_blocks)

    def added_blocks(self, epoch: int) -> range:
        if epoch < self.base_epochs:
            per = self.base_blocks // self.base_epochs
            return range(per * epoch, per * (epoch + 1))
        t = epoch - self.base_epochs + 1
        lo = self.base_blocks + (t - 1) * self.epoch_blocks
        return range(lo, lo + self.epoch_blocks)

    def deleted_blocks(self, epoch: int) -> range:
        if epoch < self.base_epochs:
            return range(0)
        t = epoch - self.base_epochs + 1
        return range((t - 1) * self.epoch_blocks, t * self.epoch_blocks)


class KroneckerStream:
    """Blocks of Graph500 Kronecker edges drawn on ``device`` from
    ``seed``. ``block(b)`` returns (src, dst) int32 tensors on the device;
    recent blocks are kept so that an epoch's deletes, which are an
    earlier epoch's adds, are not drawn twice."""

    def __init__(self, gen: dict, block_edges: int, seed: int, device,
                 keep: int = 0):
        self.scale = int(gen["scale"])
        self.n = 1 << self.scale
        self.a, self.b, self.c = (float(gen["A"]), float(gen["B"]),
                                  float(gen["C"]))
        self.block_edges = int(block_edges)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.keep = keep
        self._cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # one label permutation for every run seed (the configuration's
        # label_seed), so the Kronecker positions keep their labels from
        # seed to seed; the run seed draws the edges
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(int(gen["label_seed"]), _PERM_STREAM))
        self.perm = torch.randperm(self.n, generator=g, device=self.device)

    def _generator(self, stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(self.seed, stream))
        return g

    def draw(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Block ``b`` drawn afresh (no cache)."""
        g = self._generator(_BLOCK_STREAM0 + b)
        r = torch.rand((2, self.scale, self.block_edges), generator=g,
                       device=self.device)
        ab = self.a + self.b
        c_norm = self.c / (1.0 - ab)
        a_norm = self.a / ab
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        weights = (1 << torch.arange(self.scale, device=self.device,
                                     dtype=torch.int64))[:, None]
        src = (ii.to(torch.int64) * weights).sum(0)
        dst = (jj.to(torch.int64) * weights).sum(0)
        return (self.perm[src].to(torch.int32).contiguous(),
                self.perm[dst].to(torch.int32).contiguous())

    def block(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        hit = self._cache.get(b)
        if hit is not None:
            return hit
        out = self.draw(b)
        if self.keep:
            self._cache[b] = out
            while len(self._cache) > self.keep:
                self._cache.pop(min(self._cache))
        return out

    def blocks(self, bs) -> tuple[torch.Tensor, torch.Tensor]:
        parts = [self.block(b) for b in bs]
        if not parts:
            empty = torch.zeros(0, dtype=torch.int32, device=self.device)
            return empty, empty
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
