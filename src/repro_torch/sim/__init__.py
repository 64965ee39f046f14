"""Trace-driven cache simulation + offline policy autotuning (port of
``repro.sim``; numpy on the host, no device).

The serving engine's cache/energy behavior is a deterministic function
of its routing trace — so record the trace once (or synthesize one) and
every policy question (cache budget, bit plan, warmup, prefetch,
timeline) becomes an offline replay instead of a live model run:

* :mod:`repro_torch.sim.trace` — trace schema, engine/scheduler recorder,
  npz+jsonl (de)serialization;
* :mod:`repro_torch.sim.synthetic` — seeded Zipf / phase-shift / tenant-mix /
  transition-matrix trace generators;
* :mod:`repro_torch.sim.replay` — model-free replay through the live engine's
  own charge path (exact-fidelity by construction);
* :mod:`repro_torch.sim.autotune` — policy sweeps, successive halving, Pareto
  frontier, miss-rate-SLO selection.

Traces are the reference's file format: each package replays the
other's.
"""

from repro_torch.sim.trace import (DecodeEvent, PrefillEvent, Trace,
                                   TraceMeta, TraceRecorder, engine_meta,
                                   traces_equal)
from repro_torch.sim.replay import (ReplayEngine, ReplayReport,
                                    TraceSliceStore, engine_config_from_meta,
                                    replay_trace)
from repro_torch.sim.synthetic import (SyntheticSpec, phase_shift_trace,
                                       tenant_mix_trace, tenant_phase_trace,
                                       transition_trace, zipf_trace)
from repro_torch.sim import autotune

__all__ = [
    "Trace", "TraceMeta", "TraceRecorder", "PrefillEvent", "DecodeEvent",
    "engine_meta", "traces_equal",
    "ReplayEngine", "ReplayReport", "TraceSliceStore",
    "engine_config_from_meta", "replay_trace",
    "SyntheticSpec", "zipf_trace", "phase_shift_trace",
    "tenant_mix_trace", "tenant_phase_trace", "transition_trace",
    "autotune",
]
