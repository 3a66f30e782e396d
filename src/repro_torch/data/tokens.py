"""Deterministic synthetic token pipeline for LM training. Port of
``repro.data.tokens`` (numpy, the same draws from the generator in the
same order, so the batches are bit-identical).

Host-sharded: each process materializes only its slice of the global batch
(``process_index``/``process_count``), the pattern a real multi-pod loader
follows. Sequences follow a Zipfian unigram draw with Markov bigram
structure so the loss has signal to descend.
"""

from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} is not a multiple "
                             f"of the {process_count} processes")
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // process_count
        self._rng = np.random.default_rng(seed + 7919 * process_index)
        # Zipf unigram + shared bigram shift structure
        ranks = np.arange(1, vocab_size + 1)
        p = (1.0 / ranks) / np.sum(1.0 / ranks)
        # ``Generator.choice(vocab, p=p)``'s own inverse-CDF draw (one
        # ``random()`` a token), its CDF built once rather than at every
        # position: at a vocabulary of 151,936 the rebuild took 36.8 s a
        # 32,768-position batch
        self._cdf = p.cumsum()
        self._cdf /= self._cdf[-1]
        self._shift = np.random.default_rng(seed).integers(
            1, vocab_size, size=vocab_size)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 tokens."""
        b, s = self.local_batch, self.seq_len + 1
        first = self._zipf((b, 1))
        noise = self._rng.random((b, s - 1)) < 0.25
        out = np.empty((b, s), np.int64)
        out[:, 0] = first[:, 0]
        for t in range(1, s):
            nxt = self._shift[out[:, t - 1]] % self.vocab
            rand = self._zipf(b)
            out[:, t] = np.where(noise[:, t - 1], rand, nxt)
        return out.astype(np.int32)

    def _zipf(self, size):
        return self._cdf.searchsorted(self._rng.random(size), side="right")
