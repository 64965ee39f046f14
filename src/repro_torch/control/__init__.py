"""Online SLO control: closed-loop policy adaptation for serving (a copy
of ``repro.control`` for the port, numpy only).

The subsystem that holds SliceMoE's miss-rate constraint *live*, when
tenant mixes and expert hotness shift and no static config is right for
long.  Three pieces:

* :mod:`repro_torch.control.signals` — per-tenant sliding windows over the
  charge-path counters (miss rate, low-bit fraction) and the serving
  telemetry stream (TTFT, per-token latency, energy/token).
* :mod:`repro_torch.control.partition` — :class:`TenantPartitionedCache`, the
  slice cache split into per-tenant byte-budget segments with shared
  lookup visibility but isolated eviction domains (the resizable
  analogue of the per-shard split in :mod:`repro_torch.core.shard`).
* :mod:`repro_torch.control.controller` — :class:`SLOController`, the
  decision loop: HOBBIT-style bit-plan demotion/promotion, partition
  resizing and admission throttling, each bounded by hysteresis and
  cooldown.

Enabled via ``EngineConfig.controller``; the reference's docs/control.md
has the loop diagram and the replay-fidelity argument (every cache-affecting
decision is a pure function of the charge-path stream, so a recorded
controller run replays bit-identically through
:mod:`repro_torch.sim.replay`).
"""

from repro_torch.control.controller import (ControllerConfig,
                                            SLOController, TenantSLO)
from repro_torch.control.partition import TenantPartitionedCache
from repro_torch.control.signals import SlidingWindow, TenantSignals

__all__ = ["ControllerConfig", "SLOController", "TenantSLO",
           "TenantPartitionedCache", "SlidingWindow", "TenantSignals"]
