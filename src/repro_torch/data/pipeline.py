"""Deterministic synthetic token pipeline, a copy of
``repro.data.pipeline`` (numpy only): for the same config, step and
shard the batches are the reference's, bit for bit.

Stands in for a real corpus: seedable, shard-aware (each data-parallel host
slices its own batch rows), packed fixed-length sequences with a Zipfian
unigram distribution plus induced bigram structure so a model actually has
something to learn (loss decreases measurably within a few hundred steps at
~100M scale).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Markov-ish token stream: next ~ 0.7 * bigram(prev) + 0.3 * zipf."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # low-rank bigram structure: prev token's bucket biases the next
        self.n_buckets = min(64, V)
        self.bucket_of = rng.integers(0, self.n_buckets, V)
        self.bucket_shift = rng.integers(0, V, self.n_buckets)

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        rows = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, shard))           # deterministic per (step,shard)
        V = cfg.vocab_size
        out = np.empty((rows, cfg.seq_len), np.int32)
        cur = rng.choice(V, size=rows, p=self.unigram)
        out[:, 0] = cur
        for t in range(1, cfg.seq_len):
            base = rng.choice(V, size=rows, p=self.unigram)
            biased = (cur + self.bucket_shift[self.bucket_of[cur]]) % V
            take_bigram = rng.random(rows) < 0.7
            cur = np.where(take_bigram, biased, base).astype(np.int32)
            out[:, t] = cur
        return {"tokens": out}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
