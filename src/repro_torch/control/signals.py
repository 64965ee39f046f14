"""Per-tenant sliding-window signals for the SLO controller.

A copy of ``repro.control.signals`` for the port (numpy only, no torch).

Two kinds of window, split by where the sample comes from:

* :class:`TenantWindow` — *charge-path* counters (accesses, misses,
  critical selections, low-bit-served criticals) pushed once per decode
  step from ``StepCharge.per_tenant``.  These exist identically in live
  serving and in trace replay, so every controller decision derived
  from them is replay-reproducible.
* :class:`SlidingWindow` — scalar samples from the *telemetry* stream
  (TTFT, per-token latency, energy per token).  These only exist live;
  the controller consumes them for admission throttling, which never
  touches cache/plan state (see docs/control.md).

Windows are bounded deques: O(window) memory per tenant, O(window)
aggregation at decision epochs (every ``interval`` steps), which is
noise next to a decode step.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional

from repro_torch.serving.telemetry import percentile

__all__ = ["SlidingWindow", "TenantWindow", "TenantSignals"]


class SlidingWindow:
    """Bounded window of scalar samples with mean / percentile queries."""

    def __init__(self, maxlen: int = 64):
        self._buf: Deque[float] = deque(maxlen=maxlen)

    def push(self, value: float) -> None:
        self._buf.append(float(value))

    def __len__(self) -> int:
        return len(self._buf)

    def mean(self) -> Optional[float]:
        if not self._buf:
            return None
        return sum(self._buf) / len(self._buf)

    def percentile(self, q: float) -> Optional[float]:
        if not self._buf:
            return None             # telemetry's percentile() gives nan
        return percentile(list(self._buf), q)

    def clear(self) -> None:
        self._buf.clear()


class TenantWindow:
    """Window of per-step charge-path count rows for one tenant.

    A row is the tenant's slice of ``StepCharge.per_tenant``:
    ``{"tokens", "accesses", "misses", "critical", "critical_low"}``.
    Ratios are computed over the *summed* window, not averaged per step,
    so steps with more traffic weigh more — the quantity the paper's
    miss-rate constraint is stated over.
    """

    _KEYS = ("tokens", "accesses", "misses", "critical", "critical_low")

    def __init__(self, maxlen: int = 64):
        self._buf: Deque[Dict[str, int]] = deque(maxlen=maxlen)

    def push(self, row: Dict[str, int]) -> None:
        self._buf.append({k: int(row.get(k, 0)) for k in self._KEYS})

    def __len__(self) -> int:
        return len(self._buf)

    def _sum(self, key: str) -> int:
        return sum(r[key] for r in self._buf)

    @property
    def total_accesses(self) -> int:
        return self._sum("accesses")

    @property
    def total_tokens(self) -> int:
        return self._sum("tokens")

    def miss_rate(self) -> Optional[float]:
        acc = self._sum("accesses")
        if acc == 0:
            return None
        return self._sum("misses") / acc

    def lowbit_frac(self) -> Optional[float]:
        """Fraction of critical selections served at low precision."""
        crit = self._sum("critical")
        if crit == 0:
            return None
        return self._sum("critical_low") / crit

    def clear(self) -> None:
        self._buf.clear()


@dataclasses.dataclass
class TenantSignals:
    """Telemetry-side windows for one tenant (live serving only)."""

    window: int = 64

    def __post_init__(self):
        self.ttft_s = SlidingWindow(self.window)
        self.per_token_s = SlidingWindow(self.window)
        self.energy_per_token_j = SlidingWindow(self.window)
        self.n_submitted = 0

    def on_submit(self) -> None:
        self.n_submitted += 1

    def on_first_token(self, ttft_s: Optional[float]) -> None:
        if ttft_s is not None:
            self.ttft_s.push(ttft_s)

    def on_finish(self, per_token_s: Optional[float],
                  energy_per_token_j: Optional[float] = None) -> None:
        if per_token_s is not None:
            self.per_token_s.push(per_token_s)
        if energy_per_token_j is not None:
            self.energy_per_token_j.push(energy_per_token_j)

    def summary(self) -> dict:
        return {
            "n_submitted": self.n_submitted,
            "ttft_p50_s": self.ttft_s.percentile(50),
            "ttft_p95_s": self.ttft_s.percentile(95),
            "per_token_p50_s": self.per_token_s.percentile(50),
            "per_token_p95_s": self.per_token_s.percentile(95),
            "energy_per_token_p50_j":
                self.energy_per_token_j.percentile(50),
        }
