"""Closed-loop per-tenant SLO controller (bits / partition / admission).

A copy of ``repro.control.controller`` for the port (numpy only, no torch).

:class:`SLOController` holds the paper's miss-rate constraint *online*:
instead of one static config from the offline autotuner, it watches
per-tenant sliding windows and moves three bounded actuators:

* **Bit plan** (HOBBIT-style): demote a tenant to MSB-only decode.
  AMAT's truncation property makes demotion *free* — the MSB slice is
  itself a valid low-precision tensor, so no re-quantization or extra
  I/O happens; the tenant simply stops demanding LSB slices, which
  removes its LSB fetch misses (miss-rate relief) and its LSB
  fetch/read energy plus the high-bit matmul premium (energy relief).
  Promotion is driven by the *accuracy guard*: a demoted tenant whose
  served low-bit fraction exceeds its ``lowbit_frac`` SLO is promoted
  back.  ``bit_floor="high"`` pins a tenant at full precision.
* **Cache partition**: shift DRAM bytes between tenant segments of a
  :class:`~repro_torch.control.partition.TenantPartitionedCache` (bounded
  step size, per-tenant floor).
* **Admission** (live serving only): deterministically thin admission
  of tenants without a TTFT SLO when some tenant's TTFT p95 violates
  its SLO.  This actuator never touches cache/plan state.

Stability comes from hysteresis (act only beyond ``(1 + hysteresis)``
of the target) and per-tenant cooldowns (no tenant is re-actuated for
``cooldown`` decision-steps after a move).

Replay fidelity — the load-bearing property: the bit and partition
actuators consume **only charge-path counters** (``StepCharge.
per_tenant``), which a recorded trace reproduces exactly, and they are
applied at a fixed point *inside* the engine's charge path.  A replayed
controller run therefore recomputes the identical decision sequence and
the identical per-epoch miss counts as the live run (gated by
``benchmarks/controller_soak.py``).  The admission actuator consumes
wall-clock telemetry and is deliberately excluded from that loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.control.signals import TenantSignals, TenantWindow

__all__ = ["TenantSLO", "ControllerConfig", "SLOController"]


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """Per-tenant service-level objectives.

    ``None`` disables the corresponding objective.  ``lowbit_frac`` is
    the tolerated fraction of *critical* (gate >= theta) selections
    served at low precision — 1.0 means the tenant accepts full
    demotion, 0.0 none.  ``bit_floor="high"`` exempts the tenant from
    bit demotion entirely.
    """

    miss_rate: Optional[float] = None
    lowbit_frac: float = 1.0
    ttft_s: Optional[float] = None
    bit_floor: str = "low"          # "low" (demotable) | "high" (pinned)

    def __post_init__(self):
        if self.bit_floor not in ("low", "high"):
            raise ValueError(f"bit_floor must be 'low' or 'high', "
                             f"got {self.bit_floor!r}")
        if not 0.0 <= self.lowbit_frac <= 1.0:
            raise ValueError(f"lowbit_frac must be in [0, 1], "
                             f"got {self.lowbit_frac}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSLO":
        return cls(**d)


@dataclasses.dataclass
class ControllerConfig:
    """SLO specs plus loop-stability and actuator-bound knobs.

    JSON-clean via :meth:`to_dict` / :meth:`from_dict` so it rides in
    ``TraceMeta.engine`` like every other policy knob (which is what
    makes controller policies sweepable in :mod:`repro_torch.sim.autotune`).
    """

    slos: Dict[str, TenantSLO]
    interval: int = 16              # decode steps between decisions
    window: int = 64                # steps of signal history per tenant
    cooldown: int = 32              # steps before re-actuating a tenant
    hysteresis: float = 0.1         # act only beyond (1+h) * target
    bits: bool = True               # enable the bit-plan actuator
    partition: bool = True          # enable the cache-partition actuator
    admission: bool = True          # enable the admission actuator (live)
    partition_step_frac: float = 0.1    # bytes moved per decision, as a
    partition_floor_frac: float = 0.1   # fraction of the tenant pool
    shared_frac: float = 0.25       # cache fraction kept unpartitioned
    admit_step: float = 0.25        # admit_frac cut per violation tick
    min_admit_frac: float = 0.25    # throttling never drops below this

    def __post_init__(self):
        self.slos = {t: (s if isinstance(s, TenantSLO)
                         else TenantSLO.from_dict(dict(s)))
                     for t, s in self.slos.items()}
        if not self.slos:
            raise ValueError("ControllerConfig needs >= 1 tenant SLO")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["slos"] = {t: s.to_dict() for t, s in self.slos.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ControllerConfig":
        return cls(**dict(d))


class SLOController:
    """The decision loop.  One instance per engine, tenants fixed at
    construction (the sorted SLO keys — also the cache partition)."""

    def __init__(self, cfg: ControllerConfig, *, cache_bytes: float):
        self.cfg = cfg
        self.tenants: List[str] = sorted(cfg.slos)
        # --- charge-path state (replay-reproducible) ---
        self.levels: Dict[str, int] = {t: 0 for t in self.tenants}
        self.windows: Dict[str, TenantWindow] = {
            t: TenantWindow(cfg.window) for t in self.tenants}
        pool = (1.0 - cfg.shared_frac) * float(cache_bytes)
        self.budgets: Dict[str, float] = {
            t: pool / len(self.tenants) for t in self.tenants}
        self._pool = pool
        self._step = 0
        self._cooldown_until: Dict[str, int] = {t: 0 for t in self.tenants}
        self.actions: List[dict] = []
        # --- telemetry-side state (live serving only) ---
        self.signals: Dict[str, TenantSignals] = {
            t: TenantSignals(cfg.window) for t in self.tenants}
        self.admit_fracs: Dict[str, float] = {t: 1.0 for t in self.tenants}
        self._admit_seen: Dict[str, int] = {}
        self._live_steps = 0

    # ================= charge-path side (replay-reproducible) =========
    def plan_bits(self, slot_tenants: Optional[list],
                  n_slots: int) -> np.ndarray:
        """Per-slot bit level for this decode step: 0 = full AMAT plan,
        1 = demoted (MSB-only).  Unknown tenants run at full precision."""
        levels = np.zeros(n_slots, np.int8)
        if slot_tenants is not None:
            for b, t in enumerate(slot_tenants[:n_slots]):
                if t is not None:
                    levels[b] = self.levels.get(t, 0)
        return levels

    def observe_step(self, per_tenant: Dict[str, Dict[str, int]],
                     ledger_delta: Optional[dict] = None
                     ) -> Dict[str, Any]:
        """Ingest one decode step's charge counters; every ``interval``
        steps run the decision pass.  Returns actuator outputs for the
        engine to apply (currently only ``{"budgets": ...}``)."""
        for t, row in per_tenant.items():
            if t in self.windows:
                self.windows[t].push(row)
        self._step += 1
        if self._step % self.cfg.interval != 0:
            return {}
        return self._decide()

    def _log(self, kind: str, tenant: str, **detail) -> None:
        self.actions.append({"step": self._step, "kind": kind,
                             "tenant": tenant, **detail})

    def _cooled(self, tenant: str) -> bool:
        return self._step >= self._cooldown_until[tenant]

    def _touch(self, tenant: str) -> None:
        self._cooldown_until[tenant] = self._step + self.cfg.cooldown

    def _decide(self) -> Dict[str, Any]:
        cfg = self.cfg
        out: Dict[str, Any] = {}

        # 1. Accuracy guard: promote any demoted tenant whose served
        #    low-bit fraction exceeds its SLO.  Runs before the miss
        #    pass so a promotion and a re-demotion cannot land in the
        #    same tick (the cooldown then keeps them apart).
        for t in self.tenants:
            if self.levels[t] == 0 or not self._cooled(t):
                continue
            lf = self.windows[t].lowbit_frac()
            if lf is not None and lf > cfg.slos[t].lowbit_frac:
                self.levels[t] = 0
                self._touch(t)
                self._log("promote", t, lowbit_frac=lf)

        # 2. Miss-rate pass: for each violating tenant, escalate
        #    demote-self -> pull budget from the richest quiet tenant.
        violators = []
        for t in self.tenants:
            target = cfg.slos[t].miss_rate
            if target is None:
                continue
            mr = self.windows[t].miss_rate()
            if mr is not None and mr > target * (1.0 + cfg.hysteresis):
                violators.append(t)

        step_bytes = cfg.partition_step_frac * self._pool
        floor = cfg.partition_floor_frac * self._pool
        for t in violators:
            if not self._cooled(t):
                continue
            mr = self.windows[t].miss_rate()
            if (cfg.bits and self.levels[t] == 0
                    and cfg.slos[t].bit_floor != "high"):
                self.levels[t] = 1
                self._touch(t)
                self._log("demote", t, miss_rate=mr)
                continue
            if not cfg.partition:
                continue
            donors = [d for d in self.tenants
                      if d not in violators
                      and self.budgets[d] - step_bytes >= floor]
            if not donors:
                continue
            donor = max(donors, key=lambda d: (self.budgets[d], d))
            self.budgets[donor] -= step_bytes
            self.budgets[t] += step_bytes
            self._touch(t)
            self._log("repartition", t, donor=donor,
                      bytes=step_bytes, miss_rate=mr)
            out["budgets"] = dict(self.budgets)
        return out

    # ================= telemetry side (live serving only) =============
    def attach_telemetry(self, telemetry) -> None:
        telemetry.add_listener(self)

    def on_submit(self, record) -> None:
        t = getattr(record, "tenant", None)
        if t in self.signals:
            self.signals[t].on_submit()

    def on_first_token(self, record) -> None:
        t = getattr(record, "tenant", None)
        if t in self.signals:
            self.signals[t].on_first_token(record.ttft)

    def on_step(self, step) -> None:
        self._live_steps += 1
        if self.cfg.admission and self._live_steps % self.cfg.interval == 0:
            self._admit_tick()

    def _admit_tick(self) -> None:
        cfg = self.cfg
        violated = False
        for t in self.tenants:
            slo = cfg.slos[t]
            if slo.ttft_s is None:
                continue
            p95 = self.signals[t].ttft_s.percentile(95)
            if p95 is not None and p95 > slo.ttft_s * (1 + cfg.hysteresis):
                violated = True
                self._log("ttft_violation", t, ttft_p95_s=p95)
        # Throttle the tenants *without* a TTFT SLO (background traffic)
        # when any latency-sensitive tenant is violating; relax everyone
        # back toward full admission otherwise.
        for t in self.tenants:
            if violated and cfg.slos[t].ttft_s is None:
                self.admit_fracs[t] = max(
                    cfg.min_admit_frac,
                    self.admit_fracs[t] - cfg.admit_step)
            elif not violated:
                self.admit_fracs[t] = min(
                    1.0, self.admit_fracs[t] + cfg.admit_step)

    def admit_request(self, req) -> bool:
        """Deterministic admission thinning: with ``admit_frac = f``,
        admit the n-th arrival of a tenant iff ``floor(n*f)`` advanced —
        an evenly spaced f-fraction, reproducible run to run."""
        t = getattr(req, "tenant", "default")
        frac = self.admit_fracs.get(t, 1.0)
        n = self._admit_seen.get(t, 0) + 1
        self._admit_seen[t] = n
        if frac >= 1.0:
            return True
        return math.floor(n * frac) > math.floor((n - 1) * frac)

    # ================= reporting ======================================
    def low_bit_fraction(self) -> float:
        """Fraction of tenants currently actuated below full precision
        (level > 0) — the scalar the metrics registry samples per step
        instead of diffing the whole ``levels`` dict."""
        if not self.levels:
            return 0.0
        return sum(1 for lvl in self.levels.values() if lvl > 0) \
            / len(self.levels)

    def summary(self) -> dict:
        return {
            "steps": self._step,
            "levels": dict(self.levels),
            "budgets": dict(self.budgets),
            "admit_fracs": dict(self.admit_fracs),
            "n_actions": len(self.actions),
            "actions_tail": self.actions[-8:],
            "low_bit_fraction": self.low_bit_fraction(),
        }
