"""Deterministic, stateless token pipeline.

A copy of ``repro.data.tokens`` (numpy only; the port may not import the
JAX package): the same seed and index give the same batch in both.

``batch(i)`` is a pure function of (seed, i): any host can recompute any
microbatch after a failure or re-shard — there is no shuffle state to lose,
which is the straggler/elasticity story at 1000+ nodes.
The stream is a synthetic Zipf-ish mixture with local n-gram structure so
cross-entropy actually decreases during the example runs.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # fixed bigram transition structure (low-rank) shared by all batches
        k = 16
        self._emit = rng.dirichlet(np.ones(vocab) * 0.05, size=k)
        self._trans = rng.dirichlet(np.ones(k), size=k)

    def batch_at(self, i: int):
        rng = np.random.default_rng((self.seed, i))
        b, s = self.batch, self.seq_len
        states = rng.integers(0, self._trans.shape[0], size=b)
        toks = np.empty((b, s + 1), np.int32)
        for t in range(s + 1):
            for j in range(b):
                toks[j, t] = rng.choice(self.vocab, p=self._emit[states[j]])
            states = np.array([rng.choice(len(self._trans), p=self._trans[st])
                               for st in states])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FastTokenStream:
    """Vectorised variant for larger batches (unigram mixture, still
    stateless-deterministic)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed

    def batch_at(self, i: int):
        rng = np.random.default_rng((self.seed, i))
        b, s = self.batch, self.seq_len
        # Zipf marginal + deterministic "copy previous token" structure
        base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = (base % self.vocab).astype(np.int32)
        copy = rng.random((b, s + 1)) < 0.3
        for t in range(1, s + 1):
            toks[:, t] = np.where(copy[:, t], toks[:, t - 1], toks[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
