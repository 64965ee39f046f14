"""Serving subsystem: continuous batching over a persistent SliceMoE engine
(port of ``repro.serving``; the same public names).

Layers:
  * :mod:`repro_torch.serving.scheduler` — admission control + continuous
    batching (slot packing, interleaved prefill, per-sequence retirement)
  * :mod:`repro_torch.serving.workloads` — deterministic traffic
    generation (Poisson / bursty / closed-loop, multi-tenant mixes)
  * :mod:`repro_torch.serving.telemetry` — per-request records, fleet
    percentiles, energy/token, warm-vs-cold miss curves
  * :mod:`repro_torch.serving.server` — the single-batch API, a
    compatibility wrapper over the scheduler
"""

from repro_torch.serving.scheduler import (Completion,
                                           ContinuousBatchingScheduler,
                                           Request, SchedulerConfig)
from repro_torch.serving.server import PlainEngine, SliceMoEServer
from repro_torch.serving.telemetry import FleetTelemetry, percentile
from repro_torch.serving.workloads import (LengthDist, TenantSpec,
                                           TimedRequest, WorkloadConfig,
                                           generate, scenario)

__all__ = [
    "Completion", "ContinuousBatchingScheduler", "Request",
    "SchedulerConfig", "PlainEngine", "SliceMoEServer", "FleetTelemetry",
    "percentile", "LengthDist", "TenantSpec", "TimedRequest",
    "WorkloadConfig", "generate", "scenario",
]
