"""Traffic scenario generation for the serving subsystem (port of
``repro.serving.workloads``, numpy only).

Produces deterministic (seeded) request streams with configurable
arrival processes, prompt/output length distributions and multi-tenant
mixes, so the scheduler can be exercised under the traffic shapes a
production deployment sees:

* ``poisson``     — exponential inter-arrival gaps at ``rate`` req/s of
  *simulated* time (the steady-traffic baseline).
* ``bursty``      — Poisson bursts: idle gaps between bursts of
  ``burst_size`` near-simultaneous arrivals (flash-crowd shape; stresses
  admission control and queue depth).
* ``closed_loop`` — all requests available at t=0 (offered load is
  admission-limited; measures pure service capacity).

Tenants model distinct workload classes sharing one engine (e.g. chat
vs. summarization): each has its own length distributions and a mix
weight.  Token ids are drawn from a per-tenant Zipf so different tenants
exercise *different* expert subsets — the interesting case for a shared
slice cache.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Integer length distribution: 'fixed' | 'uniform' | 'lognormal'.

    ``max_len`` bounds the lognormal's unbounded upper tail (a rare
    multi-sigma draw used to exceed the scheduler's prompt+max_new
    budget and get the whole request rejected at admission).  ``None``
    keeps the tail unbounded.
    """

    kind: str = "fixed"
    value: int = 32              # fixed: the value; lognormal: the median
    low: int = 8                 # uniform bounds
    high: int = 64
    sigma: float = 0.4           # lognormal shape
    max_len: Optional[int] = None  # upper clip for unbounded draws

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "fixed":
            return int(self.value)
        if self.kind == "uniform":
            return int(rng.integers(self.low, self.high + 1))
        if self.kind == "lognormal":
            x = rng.lognormal(mean=np.log(max(self.value, 1)),
                              sigma=self.sigma)
            return int(np.clip(round(x), 1, self.max_len))
        raise ValueError(f"unknown length dist {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str = "default"
    weight: float = 1.0
    prompt_len: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist("fixed", 32))
    output_len: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist("fixed", 16))
    # Zipf skew of the tenant's token distribution; token ids are offset
    # per-tenant so tenants route to different experts.
    zipf_a: float = 1.3
    eos_token: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    kind: str = "poisson"        # 'poisson' | 'bursty' | 'closed_loop'
    n_requests: int = 16
    rate: float = 2.0            # mean arrivals per simulated second
    burst_size: int = 4          # bursty only
    burst_gap_s: float = 2.0     # bursty: mean gap between bursts
    seed: int = 0
    tenants: Tuple[TenantSpec, ...] = (TenantSpec(),)


# Generated streams are plain scheduler Requests (arrival_time and
# tenant are first-class Request fields); the old name stays as an alias.
TimedRequest = Request


def _arrival_times(cfg: WorkloadConfig,
                   rng: np.random.Generator) -> np.ndarray:
    n = cfg.n_requests
    if cfg.kind == "closed_loop":
        return np.zeros(n)
    if cfg.kind == "poisson":
        gaps = rng.exponential(1.0 / max(cfg.rate, 1e-9), size=n)
        return np.cumsum(gaps)
    if cfg.kind == "bursty":
        times = []
        t = 0.0
        while len(times) < n:
            for _ in range(cfg.burst_size):
                if len(times) >= n:
                    break
                # jitter within the burst keeps arrival order well-defined
                times.append(t + rng.uniform(0.0, 1e-3))
            t += rng.exponential(cfg.burst_gap_s)
        return np.asarray(sorted(times))
    raise ValueError(f"unknown workload kind {cfg.kind!r}")


def _sample_prompt(tenant: TenantSpec, length: int, vocab_size: int,
                   rng: np.random.Generator) -> np.ndarray:
    # Zipf-distributed ids, rotated by a per-tenant offset so tenants
    # occupy different token (and therefore expert) neighborhoods.
    # crc32, not hash(): str hash is salted per interpreter and would
    # break the seeded-stream determinism promise.
    raw = rng.zipf(tenant.zipf_a, size=length)
    offset = zlib.crc32(tenant.name.encode()) % vocab_size
    return ((raw + offset) % vocab_size).astype(np.int32)


def generate(cfg: WorkloadConfig, vocab_size: int,
             *, start_id: int = 0) -> List[Request]:
    """Deterministic request stream, sorted by arrival time."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(cfg, rng)

    weights = np.asarray([t.weight for t in cfg.tenants], np.float64)
    weights = weights / weights.sum()

    out: List[Request] = []
    for i, t_arr in enumerate(arrivals):
        tenant = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
        plen = tenant.prompt_len.sample(rng)
        olen = tenant.output_len.sample(rng)
        out.append(Request(
            request_id=start_id + i,
            prompt=_sample_prompt(tenant, plen, vocab_size, rng),
            max_new_tokens=max(1, olen),
            arrival_time=float(t_arr),
            tenant=tenant.name,
            eos_token=tenant.eos_token,
        ))
    out.sort(key=lambda r: (r.arrival_time, r.request_id))
    return out


def generate_phased(phases: Sequence[WorkloadConfig], vocab_size: int,
                    *, gap_s: float = 0.0) -> List[Request]:
    """Concatenate per-phase streams into one phase-shifting workload.

    Each phase is a full :class:`WorkloadConfig` (its own tenant mix,
    arrival process and seed); phase ``k``'s arrivals are offset to start
    ``gap_s`` after the last arrival of phase ``k-1``, and request ids
    continue across phases.  This is how the SLO-controller soak builds
    traffic whose tenant mix *changes* mid-run — the case a static
    config cannot be right for on both sides of the shift.
    """
    out: List[Request] = []
    t0 = 0.0
    start_id = 0
    for cfg in phases:
        reqs = generate(cfg, vocab_size, start_id=start_id)
        for r in reqs:
            r.arrival_time = float(r.arrival_time) + t0
        out.extend(reqs)
        start_id += len(reqs)
        t0 = (max(r.arrival_time for r in reqs) if reqs else t0) + gap_s
    return out


def scenario(name: str, *, n_requests: int = 16, rate: float = 2.0,
             seed: int = 0) -> WorkloadConfig:
    """Named presets used by benchmarks and examples."""
    chat = TenantSpec(
        name="chat", weight=3.0,
        prompt_len=LengthDist("uniform", low=12, high=48),
        output_len=LengthDist("lognormal", value=16, sigma=0.5,
                              max_len=64))
    summarize = TenantSpec(
        name="summarize", weight=1.0,
        prompt_len=LengthDist("uniform", low=32, high=64),
        output_len=LengthDist("fixed", value=8))
    presets = {
        "steady": WorkloadConfig(
            kind="poisson", n_requests=n_requests, rate=rate, seed=seed),
        "bursty": WorkloadConfig(
            kind="bursty", n_requests=n_requests, rate=rate,
            burst_size=4, burst_gap_s=2.0 / max(rate, 1e-9), seed=seed),
        "closed_loop": WorkloadConfig(
            kind="closed_loop", n_requests=n_requests, seed=seed),
        "multi_tenant": WorkloadConfig(
            kind="poisson", n_requests=n_requests, rate=rate, seed=seed,
            tenants=(chat, summarize)),
    }
    if name not in presets:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(presets)}")
    return presets[name]
