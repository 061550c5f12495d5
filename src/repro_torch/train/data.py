"""Data pipeline: deterministic synthetic LM streams + lineage-tracked
batches (distributed views) + the graph-mutation adapter.

The Markov-chain token stream has real learnable structure (a random sparse
transition matrix), so the quickstart's loss visibly falls below the unigram
entropy floor — i.e. training is actually learning, not just driving the
bias terms.

The port of ``repro/train/data.py``: NumPy only, with the reference's rng
calls in the reference's order, so a seed gives the same batches byte for
byte in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.views import View


@dataclasses.dataclass
class MarkovLM:
    vocab_size: int
    branching: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching))

    def sample(self, rng, batch, seq):
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq):
            choice = rng.integers(0, self.branching, size=batch)
            toks[:, t + 1] = self.next_tokens[toks[:, t], choice]
        return toks


class TokenPipeline:
    """Deterministic, restartable pipeline: batch i is a pure function of
    (seed, i) — a distributed view whose lineage is just its index, so a
    failed/elastic-restarted worker regenerates any batch exactly."""

    def __init__(self, vocab_size, batch, seq, *, seed=0, frames_dim=None):
        self.lm = MarkovLM(vocab_size, seed=seed)
        self.batch, self.seq, self.seed = batch, seq, seed
        self.frames_dim = frames_dim

    def batch_view(self, index: int) -> View:
        def produce():
            rng = np.random.default_rng((self.seed, index))
            toks = self.lm.sample(rng, self.batch, self.seq)
            batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
            if self.frames_dim:  # frames-mode archs: stub frontend embeddings
                emb_rng = np.random.default_rng((self.seed, index, 7))
                batch["inputs"] = emb_rng.standard_normal(
                    (self.batch, self.seq, self.frames_dim)).astype(np.float32)
            return batch
        return View.source(f"batch[{index}]", produce)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_view(i).value()
            i += 1


def unigram_entropy_floor(lm: MarkovLM) -> float:
    """Entropy of the stationary unigram distribution (nats) — the loss a
    context-blind model converges to; the Markov structure admits lower."""
    counts = np.bincount(lm.next_tokens.reshape(-1),
                         minlength=lm.vocab_size).astype(np.float64)
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())
