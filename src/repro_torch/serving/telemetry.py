"""Serving telemetry: per-request records and fleet aggregates.

A copy of ``repro.serving.telemetry`` for the port (pure Python).

Two clocks run through the serving subsystem:

* **simulated time** — the deterministic latency accumulated by the
  :class:`~repro_torch.hw.energy.CostLedger` (Flash fills, DRAM reads, XPU
  matmuls on the modeled SoC).  All latency/throughput numbers the
  benchmarks report are in this clock, so results are reproducible on
  any host.
* **wall time** — host-side ``perf_counter`` spans, reported separately
  (jit compiles dominate it on small configs; it is *not* the paper
  metric).

Percentiles use the nearest-rank definition (ceil(p/100 * N)-th smallest)
— deterministic, no interpolation, exact for small N.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Dict, List, Optional


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile; p in [0, 100].

    Well-defined on every input the serving stack can produce:

    * empty input -> ``nan`` (never an exception — a summary over zero
      completed requests is still a summary);
    * a single sample is every percentile of itself (p=0 through 100);
    * accepts any sized iterable, including numpy arrays (no reliance
      on truthiness, which is ambiguous for ndarrays) and numpy
      scalars inside (result is always a builtin ``float``);
    * p outside [0, 100] raises ``ValueError`` even for empty input —
      a bad percentile is a caller bug, not a data condition.
    """
    if not 0 <= p <= 100:
        raise ValueError(f"percentile {p} out of range")
    ordered = sorted(float(v) for v in values)
    if len(ordered) == 0:
        return float("nan")
    if p == 0:
        return ordered[0]
    rank = math.ceil(p / 100.0 * len(ordered))
    return ordered[rank - 1]


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps (simulated clock) and counters for one request."""

    request_id: int
    tenant: str = "default"
    prompt_len: int = 0
    arrival_t: float = 0.0
    admit_t: float = 0.0            # prefill started
    first_token_t: float = 0.0      # first decode token produced
    finish_t: float = 0.0
    n_generated: int = 0
    rejected: bool = False
    truncated: bool = False         # prompt clipped to fit max_seq budget
    miss_sum: float = 0.0           # per-step selection-weighted miss rates
    miss_steps: int = 0

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def queue_delay(self) -> float:
        return self.admit_t - self.arrival_t

    @property
    def decode_s(self) -> float:
        return self.finish_t - self.first_token_t

    @property
    def per_token_s(self) -> float:
        if self.n_generated <= 1:
            return 0.0
        return self.decode_s / (self.n_generated - 1)

    @property
    def mean_miss_rate(self) -> float:
        return self.miss_sum / max(self.miss_steps, 1)


@dataclasses.dataclass
class StepRecord:
    """One batched decode step: fleet-level counters.

    ``latency_s`` is the step's advance of the timeline makespan.  Under
    the async slice-I/O timeline (``EngineConfig.async_io``) it is less
    than the sum of the step's transfer/compute durations; the gap is
    reported as ``overlap_saved_s`` (latency hidden by channel overlap)
    while ``io_stall_s`` is the time the XPU sat idle waiting on slice
    data this step.  Both are 0 under the serialized replay.
    """

    t: float                 # simulated time at end of step
    n_active: int
    miss_rate: float         # expert-level fleet miss rate this step
    latency_s: float         # simulated step latency
    energy_j: float
    io_stall_s: float = 0.0
    overlap_saved_s: float = 0.0
    # Per-tenant charge counters for the step (tenant -> {tokens,
    # accesses, misses, critical, critical_low}), populated when the
    # engine attributes its charge path (slot tenants known).  Feeds the
    # always-on per-tenant summary breakdown and the SLO controller.
    per_tenant: Optional[Dict[str, dict]] = None


class FleetTelemetry:
    """Aggregates request + step records into the serving report."""

    def __init__(self):
        self.requests: Dict[int, RequestRecord] = {}
        self.steps: List[StepRecord] = []
        self.rejected: List[int] = []
        # Listeners (the SLO controller) receive the same records as
        # they land; each listener method is optional.
        self.listeners: List[object] = []

    def add_listener(self, listener: object) -> object:
        """Forward on_submit/on_first_token/on_step events to ``listener``
        (any missing method is skipped).  Returns the listener."""
        self.listeners.append(listener)
        return listener

    def _emit(self, method: str, record) -> None:
        for lst in self.listeners:
            fn = getattr(lst, method, None)
            if fn is not None:
                fn(record)

    # ------------------------------------------------------------ recording
    def on_submit(self, record: RequestRecord) -> None:
        self.requests[record.request_id] = record
        self._emit("on_submit", record)

    def on_reject(self, record: RequestRecord) -> None:
        record.rejected = True
        self.requests[record.request_id] = record
        self.rejected.append(record.request_id)

    def on_first_token(self, record: RequestRecord) -> None:
        """Called by the scheduler the step a request's first token lands
        (record.first_token_t is already set) — TTFT is observable here,
        not at finish, which is what admission control needs."""
        self._emit("on_first_token", record)

    def on_step(self, record: StepRecord) -> None:
        self.steps.append(record)
        self._emit("on_step", record)

    # ----------------------------------------------------------- aggregates
    def completed(self) -> List[RequestRecord]:
        return [r for r in self.requests.values()
                if not r.rejected and r.n_generated > 0]

    def miss_rate_curve(self) -> List[float]:
        """Fleet miss rate per decode step, in execution order."""
        return [s.miss_rate for s in self.steps]

    def energy_curve(self) -> List[float]:
        """Per-decode-step ledger energy, in execution order.

        With :meth:`miss_rate_curve`, this is the live half of the
        trace-replay fidelity gate: a replayed trace must reproduce both
        step-by-step (see benchmarks/sim_fidelity.py).
        """
        return [s.energy_j for s in self.steps]

    def latency_curve(self) -> List[float]:
        """Per-decode-step simulated latency, in execution order."""
        return [s.latency_s for s in self.steps]

    def steady_state_miss_rate(self, skip_frac: float = 0.5) -> float:
        """Mean fleet miss rate over the trailing (1-skip_frac) of steps."""
        curve = self.miss_rate_curve()
        if not curve:
            return float("nan")
        tail = curve[int(len(curve) * skip_frac):] or curve
        return sum(tail) / len(tail)

    def summary(self, *, total_energy_j: Optional[float] = None,
                wall_s: Optional[float] = None,
                per_shard: Optional[list] = None,
                prefetch: Optional[dict] = None,
                placement: Optional[dict] = None) -> dict:
        """Fleet aggregates.  ``per_shard`` (expert-parallel engines
        only) is the engine's shard breakdown — per-shard cache
        miss/energy/makespan rows — attached verbatim under
        ``"per_shard"``, and additionally summarized into shard-balance
        metrics (miss-rate spread, access imbalance).  ``prefetch``
        (prefetch-enabled engines only) is the prefetcher's outcome
        summary — issued/useful/late/wasted counts and the learned
        per-distance usefulness — attached verbatim under
        ``"prefetch"``.  ``placement`` (expert-parallel engines only) is
        the engine's placement summary — policy name, re-placement
        period, replica count, migration events/bytes — attached
        verbatim under ``"placement"``."""
        done = self.completed()
        ttfts = [r.ttft for r in done]
        per_tok = [r.per_token_s for r in done if r.n_generated > 1]
        n_tokens = sum(r.n_generated for r in done)
        sim_span = max((r.finish_t for r in done), default=0.0) - \
            min((r.arrival_t for r in done), default=0.0)
        out = {
            "n_requests": len(done),
            "n_rejected": len(self.rejected),
            "n_tokens": n_tokens,
            "sim_time_s": sim_span,
            "throughput_tok_per_s": n_tokens / sim_span if sim_span > 0
            else float("nan"),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p95_s": percentile(ttfts, 95),
            "ttft_p99_s": percentile(ttfts, 99),
            "per_token_p50_s": percentile(per_tok, 50),
            "per_token_p95_s": percentile(per_tok, 95),
            "queue_delay_p50_s": percentile(
                [r.queue_delay for r in done], 50),
            "mean_miss_rate": (
                sum(r.mean_miss_rate for r in done) / len(done)
                if done else float("nan")),
            "steady_state_miss_rate": self.steady_state_miss_rate(),
            "mean_batch_occupancy": (
                sum(s.n_active for s in self.steps) / len(self.steps)
                if self.steps else 0.0),
        }
        # Decode stall/overlap breakdown (async timeline; both 0 when
        # the engine replays serialized).
        decode_s = sum(s.latency_s for s in self.steps)
        stall_s = sum(s.io_stall_s for s in self.steps)
        saved_s = sum(s.overlap_saved_s for s in self.steps)
        out["decode_io_stall_s"] = stall_s
        out["decode_overlap_saved_s"] = saved_s
        out["decode_io_stall_frac"] = (
            stall_s / decode_s if decode_s > 0 else 0.0)
        out["decode_overlap_saved_frac"] = (
            saved_s / (decode_s + saved_s) if decode_s + saved_s > 0
            else 0.0)
        if total_energy_j is not None:
            out["energy_per_token_j"] = (
                total_energy_j / n_tokens if n_tokens else float("nan"))
        if wall_s is not None:
            out["wall_s"] = wall_s
            out["wall_tok_per_s"] = n_tokens / wall_s if wall_s > 0 \
                else float("nan")
        per_tenant: Dict[str, int] = {}
        for r in done:
            per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) \
                + r.n_generated
        if len(per_tenant) > 1:
            out["tokens_per_tenant"] = per_tenant
        out["per_tenant"] = self.per_tenant_summary()
        if per_shard is not None:
            out["per_shard"] = per_shard
            rates = [row["miss_rate"] for row in per_shard]
            accs = [row["accesses"] for row in per_shard]
            if rates:
                mean_rate = sum(rates) / len(rates)
                mean_acc = sum(accs) / len(accs)
                # Spread (max-min) and imbalance factor (max/mean): the
                # quantities the hotness placement exists to shrink.
                out["shard_miss_spread"] = max(rates) - min(rates)
                out["shard_miss_imbalance"] = (
                    max(rates) / mean_rate if mean_rate > 0 else 1.0)
                out["shard_access_imbalance"] = (
                    max(accs) / mean_acc if mean_acc > 0 else 1.0)
        if prefetch is not None:
            out["prefetch"] = prefetch
        if placement is not None:
            out["placement"] = placement
        return out

    def per_tenant_summary(self) -> Dict[str, dict]:
        """Per-tenant breakdown: request-level percentiles always, plus
        charge-attributed miss rate and energy when the steps carry
        ``per_tenant`` counters (energy is split by the tenant's token
        share of each step — the only attribution a shared batched step
        admits)."""
        groups: Dict[str, List[RequestRecord]] = {}
        for r in self.completed():
            groups.setdefault(r.tenant, []).append(r)
        out: Dict[str, dict] = {}
        for tenant in sorted(groups):
            rs = groups[tenant]
            ttfts = [r.ttft for r in rs]
            per_tok = [r.per_token_s for r in rs if r.n_generated > 1]
            out[tenant] = {
                "n_requests": len(rs),
                "n_tokens": sum(r.n_generated for r in rs),
                "ttft_p50_s": percentile(ttfts, 50),
                "ttft_p95_s": percentile(ttfts, 95),
                "per_token_p50_s": percentile(per_tok, 50),
                "per_token_p95_s": percentile(per_tok, 95),
                "mean_miss_rate": (
                    sum(r.mean_miss_rate for r in rs) / len(rs)),
            }
        acc: Dict[str, int] = {}
        miss: Dict[str, int] = {}
        energy: Dict[str, float] = {}
        for s in self.steps:
            if not s.per_tenant:
                continue
            step_tokens = sum(int(row.get("tokens", 0))
                              for row in s.per_tenant.values())
            for tenant, row in s.per_tenant.items():
                acc[tenant] = acc.get(tenant, 0) \
                    + int(row.get("accesses", 0))
                miss[tenant] = miss.get(tenant, 0) \
                    + int(row.get("misses", 0))
                if step_tokens > 0:
                    energy[tenant] = energy.get(tenant, 0.0) + \
                        s.energy_j * int(row.get("tokens", 0)) / step_tokens
        for tenant, cell in out.items():
            if acc.get(tenant):
                cell["charged_miss_rate"] = miss[tenant] / acc[tenant]
            if tenant in energy and cell["n_tokens"]:
                cell["energy_per_token_j"] = \
                    energy[tenant] / cell["n_tokens"]
        return out


def format_summary(s: dict, title: str = "serving summary") -> str:
    """Render a summary dict as an indented text block.

    Handles everything :meth:`FleetTelemetry.summary` can emit: nested
    dicts, lists of dicts (``per_shard`` rows get an indexed sub-block
    each), numpy scalars (formatted as numbers, not
    ``np.float32(...)`` reprs), ``nan``, and empty containers.
    """
    lines = [f"--- {title} ---"]

    def _scalar(v) -> str:
        if isinstance(v, bool):
            return str(v)
        if isinstance(v, numbers.Integral):
            return str(int(v))
        if isinstance(v, numbers.Real):
            return f"{float(v):.6g}"
        return str(v)

    def _emit(d: dict, indent: int) -> None:
        pad = " " * indent
        for k, v in d.items():
            if isinstance(v, dict):
                lines.append(f"{pad}{k:>26}:")
                _emit(v, indent + 2)
            elif isinstance(v, (list, tuple)) and \
                    any(isinstance(e, dict) for e in v):
                lines.append(f"{pad}{k:>26}:")
                for i, e in enumerate(v):
                    if isinstance(e, dict):
                        lines.append(f"{pad}  {f'[{i}]':>26}:")
                        _emit(e, indent + 4)
                    else:
                        lines.append(f"{pad}  {f'[{i}]':>26}: {_scalar(e)}")
            elif isinstance(v, (list, tuple)):
                body = ", ".join(_scalar(e) for e in v)
                lines.append(f"{pad}{k:>26}: [{body}]")
            else:
                lines.append(f"{pad}{k:>26}: {_scalar(v)}")

    _emit(s, 2)
    return "\n".join(lines)
