"""Offline policy autotuner over recorded / synthetic routing traces (port
of ``repro.sim.autotune``).

Sweeps engine-policy knobs (cache capacity, AMAT bit plans, slice mode,
warmup policy, ``lsb_keep_frac``, prefetch, async timeline, controller
target) by replaying one trace per candidate through
:class:`~repro_torch.sim.replay.ReplayEngine` — thousands of policy points
per minute instead of one live run per point.  Outputs the
energy/latency/miss Pareto frontier and the cheapest configuration
meeting a miss-rate SLO.

Two search modes:

* :func:`sweep` — evaluate every candidate on the full trace (exact).
* :func:`sweep` with ``successive_halving=True`` — evaluate all
  candidates on a trace prefix, keep the best ``1/eta`` fraction, resume
  the survivors (their simulation state is *kept*, not recomputed) on a
  longer prefix, repeat until the survivors finish the trace.  Losers
  report partial metrics (``partial=True``).

Candidate encoding: a dict of ``TraceMeta.engine`` knob overrides (see
:func:`repro_torch.sim.replay.engine_config_from_meta`); :func:`grid` builds a
cartesian product of axes.  The empty dict is the recorded/default
config — always include it so "better than default" claims are measured
on the same replay, not against live numbers.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.sim.replay import ReplayEngine, ReplayReport
from repro_torch.sim.trace import Trace

__all__ = ["TuneResult", "grid", "evaluate", "sweep", "pareto_frontier",
           "best_under_slo", "format_results"]

Policy = Union[Dict[str, Any], Tuple[str, Dict[str, Any]]]


@dataclasses.dataclass
class TuneResult:
    """One policy point's replayed cost/quality coordinates."""

    name: str
    overrides: Dict[str, Any]
    miss_rate: float               # decode-phase expert-access miss rate
    energy_j: float
    latency_s: float
    steps_per_s: float
    events_consumed: int
    partial: bool = False          # eliminated before finishing the trace
    report: Optional[ReplayReport] = None

    def meets_slo(self, miss_slo: float) -> bool:
        return not self.partial and self.miss_rate <= miss_slo

    def row(self) -> dict:
        return {
            "name": self.name, "overrides": self.overrides,
            "miss_rate": self.miss_rate, "energy_j": self.energy_j,
            "latency_s": self.latency_s,
            "steps_per_s": self.steps_per_s, "partial": self.partial,
        }


def _auto_name(overrides: Dict[str, Any]) -> str:
    if not overrides:
        return "default"
    return ",".join(f"{k}={v}" for k, v in sorted(overrides.items()))


def _normalize(policies: Sequence[Policy]) -> List[Tuple[str, dict]]:
    out = []
    for p in policies:
        if isinstance(p, dict):
            out.append((_auto_name(p), p))
        else:
            name, ov = p
            out.append((name, dict(ov)))
    return out


def grid(**axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of knob axes as override dicts.

    >>> from repro_torch.sim.autotune import grid
    >>> grid(cache_bytes=[1e6, 2e6], warmup=["pcw", "empty"])[0]
    {'cache_bytes': 1000000.0, 'warmup': 'pcw'}
    """
    keys = list(axes)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


def _result(name: str, overrides: dict, engine: ReplayEngine,
            consumed: int, *, partial: bool) -> TuneResult:
    report = engine.report() if partial else engine.finish()
    return TuneResult(
        name=name, overrides=dict(overrides),
        miss_rate=report.decode_miss_rate,
        energy_j=report.total_energy_j,
        latency_s=report.total_latency_s,
        steps_per_s=report.steps_per_s,
        events_consumed=consumed, partial=partial, report=report)


def evaluate(trace: Trace, overrides: Optional[dict] = None,
             name: Optional[str] = None) -> TuneResult:
    """Replay the full trace under one policy point."""
    overrides = dict(overrides or {})
    eng = ReplayEngine(trace.meta, **overrides)
    eng.consume_all(trace.events)
    return _result(name or _auto_name(overrides), overrides, eng,
                   len(trace.events), partial=False)


def sweep(trace: Trace, policies: Sequence[Policy], *,
          miss_slo: Optional[float] = None,
          successive_halving: bool = False, eta: int = 2,
          min_frac: float = 0.25) -> List[TuneResult]:
    """Evaluate every policy point; optionally successive-halving.

    With ``successive_halving``, rung ``i`` extends each surviving
    candidate's replay to a ``min_frac * eta**i`` fraction of the trace,
    then keeps the best ``ceil(n/eta)`` by (SLO violation, energy so
    far).  Survivor state is resumed, never recomputed — the rung cost
    is only the *new* events.
    """
    named = _normalize(policies)
    if not successive_halving:
        return [evaluate(trace, ov, name) for name, ov in named]

    n = len(trace.events)
    fracs: List[float] = []
    f = min(max(min_frac, 1e-9), 1.0)
    while f < 1.0:
        fracs.append(f)
        f *= eta
    fracs.append(1.0)

    alive = [{"name": name, "ov": ov,
              "engine": ReplayEngine(trace.meta, **ov), "pos": 0}
             for name, ov in named]
    results: List[TuneResult] = []
    for frac in fracs:
        upto = min(n, math.ceil(frac * n))
        for s in alive:
            s["engine"].consume_all(trace.events[s["pos"]:upto])
            s["pos"] = upto
        if frac >= 1.0:
            break
        keep = max(1, math.ceil(len(alive) / eta))
        if keep >= len(alive):
            continue

        def score(s):
            eng = s["engine"]
            miss = eng._decode_misses / max(eng._decode_accesses, 1)
            violated = miss_slo is not None and miss > miss_slo
            return (violated, eng.ledger.total_energy_j)

        alive.sort(key=score)
        for s in alive[keep:]:
            results.append(_result(s["name"], s["ov"], s["engine"],
                                   s["pos"], partial=True))
        alive = alive[:keep]
    for s in alive:
        results.append(_result(s["name"], s["ov"], s["engine"],
                               s["pos"], partial=False))
    return results


def pareto_frontier(results: Sequence[TuneResult],
                    *, objectives: Tuple[str, ...] = (
                        "energy_j", "latency_s", "miss_rate")
                    ) -> List[TuneResult]:
    """Non-dominated subset (all objectives minimized), stable order.

    Partial results are excluded: their metrics cover a trace prefix and
    are not comparable to full replays.
    """
    full = [r for r in results if not r.partial]

    def dominates(a: TuneResult, b: TuneResult) -> bool:
        av = [getattr(a, o) for o in objectives]
        bv = [getattr(b, o) for o in objectives]
        return all(x <= y for x, y in zip(av, bv)) and \
            any(x < y for x, y in zip(av, bv))

    return [r for r in full
            if not any(dominates(o, r) for o in full if o is not r)]


def best_under_slo(results: Sequence[TuneResult],
                   miss_slo: float) -> Optional[TuneResult]:
    """Cheapest-energy full result meeting the miss-rate SLO."""
    ok = [r for r in results if r.meets_slo(miss_slo)]
    return min(ok, key=lambda r: r.energy_j) if ok else None


def format_results(results: Sequence[TuneResult], *,
                   miss_slo: Optional[float] = None,
                   title: str = "autotune sweep") -> str:
    """Human-readable sweep table (sorted by energy, partials last)."""
    lines = [f"--- {title} ---",
             f"{'config':44s} {'miss%':>6s} {'energy mJ':>10s} "
             f"{'latency ms':>11s} {'steps/s':>9s}"]
    frontier = {id(r) for r in pareto_frontier(results)}
    for r in sorted(results, key=lambda r: (r.partial, r.energy_j)):
        flags = ""
        if id(r) in frontier:
            flags += "*"
        if miss_slo is not None and r.meets_slo(miss_slo):
            flags += "S"
        if r.partial:
            flags += "p"
        lines.append(
            f"{r.name[:42]:42s} {flags:2s} {r.miss_rate * 100:5.1f} "
            f"{r.energy_j * 1e3:10.3f} {r.latency_s * 1e3:11.3f} "
            f"{r.steps_per_s:9.0f}")
    lines.append("(* = Pareto frontier"
                 + (", S = meets SLO" if miss_slo is not None else "")
                 + ", p = eliminated early)")
    return "\n".join(lines)
