"""Synthetic LM data pipeline (a copy of ``repro.data.pipeline``).

The reference module is numpy-only; the port keeps its own copy so that
it never imports the JAX package.  Batches are equal to the reference's
for the same ``DataConfig``.

Generator: a per-stream zipf-weighted Markov chain over the vocabulary.
Each document draws a "topic" seed that biases the transition matrix rows,
so different documents exercise different token (and therefore expert)
distributions.  ``host_shard`` slices one host's share of the global
batch deterministically from the stream index.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 16
    zipf_a: float = 1.3
    topic_sharpness: float = 4.0


class SyntheticLM:
    """Deterministic zipf-markov token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # Base zipf unigram distribution.
        ranks = np.arange(1, V + 1, dtype=np.float64)
        base = ranks ** (-cfg.zipf_a)
        self.base = base / base.sum()
        # Topic biases: each topic up-weights a random band of the vocab.
        self.topic_bias = rng.dirichlet(
            np.full(V, 0.5 / np.sqrt(V)) + 1e-3, size=cfg.n_topics)

    def _doc_dist(self, topic: int) -> np.ndarray:
        s = self.cfg.topic_sharpness
        p = self.base * (1.0 + s * self.topic_bias[topic])
        return p / p.sum()

    def sample_batch(self, step: int, batch: int,
                     seq_len: Optional[int] = None) -> np.ndarray:
        """[batch, seq_len+1] tokens; deterministic in (seed, step)."""
        seq_len = seq_len or self.cfg.seq_len
        out = np.empty((batch, seq_len + 1), np.int32)
        for b in range(batch):
            rng = np.random.default_rng(
                (self.cfg.seed, step, b, 0xD00D))
            topic = int(rng.integers(self.cfg.n_topics))
            dist = self._doc_dist(topic)
            # 1st-order structure: with prob q, repeat a recent token.
            toks = rng.choice(self.cfg.vocab_size, size=seq_len + 1, p=dist)
            repeat = rng.random(seq_len + 1) < 0.3
            for t in range(4, seq_len + 1):
                if repeat[t]:
                    toks[t] = toks[t - int(rng.integers(1, 4))]
            out[b] = toks
        return out

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            full = self.sample_batch(step, self.cfg.global_batch)
            yield {
                "tokens": full[:, :-1],
                "labels": full[:, 1:],
                "step": step,
            }
            step += 1

    def host_shard(self, step: int, shard_idx: int, n_shards: int) -> dict:
        """Deterministic per-host slice of the global batch."""
        assert self.cfg.global_batch % n_shards == 0
        per = self.cfg.global_batch // n_shards
        full = self.sample_batch(step, self.cfg.global_batch)
        sl = slice(shard_idx * per, (shard_idx + 1) * per)
        return {"tokens": full[sl, :-1], "labels": full[sl, 1:]}
