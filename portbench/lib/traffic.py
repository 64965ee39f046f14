"""Closed-loop request streams drawn from a seed.

``LengthDist`` is a frozen copy of ``repro_torch.serving.workloads.
LengthDist``'s parameters with a lower clip (``min_len``) added beside its
upper one (``max_len``), drawn through its inverse CDF so that lengths can
be drawn by strata.

A mix (``portbench/traffic/<name>.json``) names a client count, a prompt
and an output length distribution, and ``strata``: the stream is cut into
blocks of ``strata`` consecutive requests, and each block holds one length
from each of ``strata`` equally likely slices of the distribution, in an
order drawn from the seed.  So two seeds serve nearly the same set of
lengths in another order, and a run's work does not swing with the seed.

Request ``i`` of the stream is the same for a seed whatever the order in
which a run asks for it: its prompt ids and both lengths come from
generators keyed by the seed and ``i`` (or its block).  The first
``clients`` requests are the first wave.  Their answer lengths are drawn,
one from each of ``clients`` equally likely slices, from what a closed
loop in its steady state has left to decode: the residual of an answer
length, ``P(R = r) = P(L >= r) / E[L]`` for ``r`` in 1..top.  So
completions do not all fall on one decode step, the loop completes
requests at its steady rate from the first step on, and every seed's
first wave holds nearly the same lengths.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Optional

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Integer length distribution: 'fixed' | 'uniform' | 'lognormal'."""

    kind: str = "fixed"
    value: int = 32              # fixed: the value; lognormal: the median
    low: int = 8                 # uniform bounds
    high: int = 64
    sigma: float = 0.4           # lognormal shape
    max_len: Optional[int] = None
    min_len: int = 1

    def quantile(self, u: float) -> int:
        """The length at cumulative probability ``u`` in (0, 1)."""
        if self.kind == "fixed":
            return int(self.value)
        if self.kind == "uniform":
            n = self.high - self.low + 1
            return int(self.low + min(int(u * n), n - 1))
        if self.kind == "lognormal":
            x = math.exp(math.log(max(self.value, 1))
                         + self.sigma * _NORMAL.inv_cdf(u))
            return self._clip(round(x))
        raise ValueError(f"unknown length dist {self.kind!r}")

    def survival(self, r: int) -> float:
        """``P(L >= r)`` for a whole number ``r``."""
        if self.kind == "fixed":
            return float(r <= self.value)
        if self.kind == "uniform":
            n = self.high - self.low + 1
            return float(min(max(self.high - r + 1, 0), n)) / n
        if self.kind == "lognormal":
            if r <= max(self.min_len, 1):
                return 1.0
            if r > self.top:
                return 0.0
            # round(x) >= r exactly where x >= r - 0.5
            return 1.0 - _NORMAL.cdf((math.log(r - 0.5)
                                      - math.log(max(self.value, 1)))
                                     / self.sigma)
        raise ValueError(f"unknown length dist {self.kind!r}")

    def _clip(self, n: int) -> int:
        hi = self.max_len if self.max_len is not None else n
        return int(min(max(n, self.min_len, 1), hi))

    @property
    def top(self) -> int:
        if self.kind == "fixed":
            return int(self.value)
        if self.kind == "uniform":
            return int(self.high)
        if self.max_len is None:
            raise ValueError("a lognormal without max_len has no top")
        return int(self.max_len)


@dataclasses.dataclass(frozen=True)
class Mix:
    """A closed-loop traffic mix (one ``traffic/<name>.json``)."""

    clients: int
    max_batch: int
    prompt: LengthDist
    output: LengthDist
    strata: int
    warmup_steps: int
    trace_steps: int

    @classmethod
    def from_json(cls, d: dict) -> "Mix":
        if d.get("loop") != "closed":
            raise ValueError(f"only closed-loop mixes exist, got {d!r}")
        return cls(clients=int(d["clients"]), max_batch=int(d["max_batch"]),
                   prompt=LengthDist(**d["prompt"]),
                   output=LengthDist(**d["output"]),
                   strata=int(d["strata"]),
                   warmup_steps=int(d["warmup_steps"]),
                   trace_steps=int(d["trace_steps"]))

    @property
    def max_seq(self) -> int:
        """KV rows a slot needs: the longest prompt, the longest answer
        and the one row the scheduler's budget keeps spare."""
        return self.prompt.top + self.output.top + 1


class Stream:
    """Request ``i`` of a mix for one seed: ``(prompt ids, max_new)``."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self._blocks: dict = {}

    def _block(self, which: int, b: int) -> np.ndarray:
        key = (which, b)
        if key not in self._blocks:
            n = self.mix.strata
            rng = np.random.default_rng([self.seed, which, b])
            u = (rng.permutation(n) + rng.random(n)) / n
            dist = self.mix.prompt if which == 0 else self.mix.output
            self._blocks[key] = np.array([dist.quantile(float(x))
                                          for x in u], np.int64)
        return self._blocks[key]

    def _first_wave(self) -> np.ndarray:
        """Answer lengths of the first wave: one from each of ``clients``
        equally likely slices of the answer length's residual, in an
        order drawn from the seed."""
        if "first" not in self._blocks:
            n, out = self.mix.clients, self.mix.output
            rng = np.random.default_rng([self.seed, 2])
            u = (rng.permutation(n) + rng.random(n)) / n
            cdf = np.cumsum([out.survival(r) for r in range(1, out.top + 1)])
            self._blocks["first"] = 1 + np.minimum(
                np.searchsorted(cdf, u * cdf[-1], side="right"),
                out.top - 1).astype(np.int64)
        return self._blocks["first"]

    def lengths(self, i: int):
        n = self.mix.strata
        p = int(self._block(0, i // n)[i % n])
        if i < self.mix.clients:
            o = int(self._first_wave()[i])
        else:
            o = int(self._block(1, i // n)[i % n])
        return p, o

    def request(self, i: int):
        p, o = self.lengths(i)
        rng = np.random.default_rng([self.seed, 3, i])
        prompt = rng.integers(0, self.vocab, p).astype(np.int32)
        return prompt, o
