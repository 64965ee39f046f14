"""Model-free trace replay: the live engine's charge path, minus the model
(port of ``repro.sim.replay``).

:class:`ReplayEngine` subclasses the port's
:class:`~repro_torch.core.engine.PersistentEngine` but never builds
params, a device or a KV cache, and touches no tensor — it rebuilds
only the state the charge path touches (``SliceCache``,
``HotnessTracker``, ``CostLedger``, the configured prefetcher, the slice
byte-size store) from a :class:`~repro.sim.trace.TraceMeta`, then feeds
recorded/synthetic routing events through the *inherited*
``_charge_prefill`` / ``charge_step_trace`` methods.  Because those are
byte-for-byte the code the live engine runs, a replay under the recorded
config reproduces the live run's per-epoch miss counts exactly and its
energy/latency bit-for-bit — while running orders of magnitude faster
(no forward pass), which is what makes policy sweeps tractable
(:mod:`repro_torch.sim.autotune`).  It replays traces recorded by either
package: the file formats are the reference's.

What a replay can and cannot vary:

* **faithful counterfactuals** — cache capacity, AMAT bit plan (slice
  bytes are recomputed from the recorded weight shapes), slice mode,
  warmup policy, ``lsb_keep_frac``, fused slices, prefetch on/off/top-m,
  serialized vs async timeline, system profile: these only change how
  the *fixed* routing stream is charged, exactly as they would have on
  the live engine had routing not shifted;
* **open-loop only** — knobs that feed back into routing (Cache-Prior
  ``alpha`` via the miss-rate controller, routing kind) cannot bend the
  recorded expert choices.  The replay still runs the controller and
  reports its ``alpha`` trajectory / SLO attainment against the replayed
  miss curve, but the routing stays the trace's.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.control.controller import ControllerConfig, SLOController
from repro_torch.core.amat import MatConfig, slice_nbytes
from repro_torch.core.engine import EngineConfig, PersistentEngine, _StepTrace
from repro_torch.core.placement import build_placement_policy
from repro_torch.core.shard import ShardedSliceCache
from repro_torch.core.slices import SliceKey
from repro_torch.core.warmup import HotnessTracker
from repro_torch.hw.energy import ShardedCostLedger
from repro_torch.hw.specs import SYSTEM_PROFILES
from repro_torch.models.moe import RoutingPolicy
from repro_torch.sim.trace import Trace, TraceMeta

__all__ = ["TraceSliceStore", "engine_config_from_meta", "ReplayEngine",
           "ReplayReport", "replay_trace"]


class TraceSliceStore:
    """Byte-size stand-in for
    :class:`~repro_torch.core.slices.ExpertSliceStore`.

    Rebuilt from trace metadata for *any* AMAT bit plan: slice bytes come
    from the same :func:`~repro_torch.core.amat.slice_nbytes` on the same
    per-expert code shapes the live store used, so byte accounting is
    identical — without holding a single weight.
    """

    def __init__(self, meta: TraceMeta, mat: MatConfig):
        self.mat = mat
        self.n_experts = meta.n_experts
        # pcw/init_* only need the flat layer keys, not weights
        self.layers: Dict[int, None] = {
            l: None for l in range(meta.n_moe_layers)}
        shapes = (meta.wi_shape, meta.wo_shape)
        self.msb_bytes_per_expert = sum(
            slice_nbytes(s, mat.high_bits, mat.group_size,
                         which="msb", shift=mat.shift) for s in shapes)
        self.lsb_bytes_per_expert = sum(
            slice_nbytes(s, mat.high_bits, mat.group_size,
                         which="lsb", shift=mat.shift) for s in shapes)

    def slice_bytes(self, key: SliceKey) -> float:
        return (self.msb_bytes_per_expert if key.kind == "msb"
                else self.lsb_bytes_per_expert)

    def highbit_expert_bytes(self) -> float:
        return self.msb_bytes_per_expert + self.lsb_bytes_per_expert

    def total_bytes(self) -> float:
        return self.highbit_expert_bytes() * len(self.layers) \
            * self.n_experts

    def all_keys(self):
        for lidx in self.layers:
            for e in range(self.n_experts):
                yield SliceKey(lidx, e, "msb")
                yield SliceKey(lidx, e, "lsb")


def engine_config_from_meta(meta: TraceMeta, **overrides) -> EngineConfig:
    """The recorded EngineConfig, with autotuner-style overrides.

    Override keys are the flat ``TraceMeta.engine`` knob names
    (``cache_bytes``, ``high_bits``, ``low_bits``, ``slice_mode``,
    ``warmup``, ``prefetch_top_m``, ``async_io``, ``ep_shards``, ...).
    Unknown keys raise, so a sweep axis typo can't silently evaluate the
    default.  ``ep_shards`` is sweepable on any trace, including one
    recorded before the knob existed (it defaults to 1), because expert
    placement is a pure function of the expert ids the trace carries.
    """
    e = dict(meta.engine)
    e.setdefault("ep_shards", 1)    # traces recorded before EP existed
    e.setdefault("prefetch_min_obs", 0)   # pre-confidence-floor traces
    e.setdefault("controller", None)      # pre-controller traces
    # Traces recorded before the request-level predictor existed carry
    # no kind: they ran (and must replay as) the transition baseline.
    e.setdefault("prefetch_kind", "transition")
    e.setdefault("prefetch_lookahead", 2)
    e.setdefault("prefetch_min_score", 0.02)
    # Traces recorded before placement was a policy ran the implicit
    # round-robin modulo; replay them under the same table.
    e.setdefault("placement", "round_robin")
    e.setdefault("placement_period", 64)
    e.setdefault("replicate_k", 0)
    unknown = set(overrides) - set(e)
    if unknown:
        raise KeyError(f"unknown engine override(s) {sorted(unknown)}; "
                       f"valid knobs: {sorted(e)}")
    e.update(overrides)
    ctl = e["controller"]
    if ctl is not None and not hasattr(ctl, "slos"):
        ctl = ControllerConfig.from_dict(ctl)
    return EngineConfig(
        mat=MatConfig(int(e["high_bits"]), int(e["low_bits"]),
                      meta.group_size),
        cache_bytes=float(e["cache_bytes"]),
        policy=RoutingPolicy(
            kind=e["policy_kind"], slice_mode=e["slice_mode"],
            theta=float(e["theta"]),
            fetch_lsb_on_miss=bool(e["fetch_lsb_on_miss"])),
        miss_rate_target=e["miss_rate_target"],
        warmup=e["warmup"],
        lsb_keep_frac=float(e["lsb_keep_frac"]),
        system=e["system"],
        fused_slices=bool(e["fused_slices"]),
        prefetch_top_m=e["prefetch_top_m"],
        async_io=bool(e["async_io"]),
        hotness_request_decay=float(e["hotness_request_decay"]),
        ep_shards=int(e["ep_shards"]),
        prefetch_min_obs=int(e["prefetch_min_obs"]),
        prefetch_kind=str(e["prefetch_kind"]),
        prefetch_lookahead=int(e["prefetch_lookahead"]),
        prefetch_min_score=float(e["prefetch_min_score"]),
        controller=ctl,
        placement=str(e["placement"]),
        placement_period=int(e["placement_period"]),
        replicate_k=int(e["replicate_k"]),
    )


@dataclasses.dataclass
class ReplayReport:
    """Everything a replayed trace yields, mirroring live telemetry."""

    n_prefills: int
    n_decode_steps: int
    miss_curve: List[float]            # fleet miss rate per decode step
    energy_curve: List[float]          # ledger energy delta per step
    decode_accesses: int
    decode_misses: int
    epoch_miss: List[Tuple[str, float]]
    epoch_counts: List[Tuple[str, int, int]]
    ledger: dict                       # final CostLedger.snapshot()
    prefetch: Optional[dict]
    alpha_curve: List[float]
    wall_s: float                      # host time, all events
    decode_wall_s: float               # host time, decode events only
    # Expert-parallel replays only: per-shard [(label, accesses, misses)]
    # epoch windows (None on single-device replays).
    per_shard_epoch_counts: Optional[list] = None
    # Controller / tenant-attributed replays only: one
    # ``StepCharge.per_tenant`` dict per decode step (None otherwise),
    # plus the final controller summary.
    per_tenant_rows: Optional[List[dict]] = None
    controller_summary: Optional[dict] = None
    # Placement-policy replays only: the migration event sequence
    # ([{step, moved, bytes}]) and the final placement summary, which a
    # replay must reproduce exactly.
    migration_events: Optional[List[dict]] = None
    placement: Optional[dict] = None

    @property
    def decode_miss_rate(self) -> float:
        return self.decode_misses / max(self.decode_accesses, 1)

    @property
    def total_energy_j(self) -> float:
        return self.ledger["total_energy_j"]

    @property
    def total_latency_s(self) -> float:
        return self.ledger["total_latency_s"]

    @property
    def steps_per_s(self) -> float:
        """Decode replay rate: decode steps over decode-event host time
        (prefill replay time is excluded — it has its own counter)."""
        return self.n_decode_steps / self.decode_wall_s \
            if self.decode_wall_s > 0 else float("inf")

    def summary(self) -> dict:
        return {
            "n_prefills": self.n_prefills,
            "n_decode_steps": self.n_decode_steps,
            "decode_miss_rate": self.decode_miss_rate,
            "total_energy_j": self.total_energy_j,
            "total_latency_s": self.total_latency_s,
            "replay_steps_per_s": self.steps_per_s,
            "alpha_final": self.alpha_curve[-1] if self.alpha_curve
            else 0.0,
            **({"prefetch": self.prefetch} if self.prefetch else {}),
            **({"controller": self.controller_summary}
               if self.controller_summary else {}),
        }


class ReplayEngine(PersistentEngine):
    """Trace-driven :class:`PersistentEngine`: same charge path, no model.

    Construct from a trace's metadata (plus optional config overrides),
    then :meth:`consume` events in order — or use the one-shot
    :func:`replay_trace`.  The live-only entry points (``run_prefill``,
    ``decode_batch``) are disabled.  It holds no device: no charge-path
    method touches one.
    """

    def __init__(self, meta: TraceMeta,
                 ecfg: Optional[EngineConfig] = None, **overrides):
        # Deliberately no super().__init__: that path quantizes params
        # on a device.  Rebuild only the charge state.
        if ecfg is None:
            ecfg = engine_config_from_meta(meta, **overrides)
        elif overrides:
            raise ValueError("pass either ecfg or overrides, not both")
        self.meta = meta
        self.cfg = SimpleNamespace(name=meta.model, d_model=meta.d_model,
                                   n_periods=meta.n_periods)
        self.ecfg = ecfg
        self.store = TraceSliceStore(meta, ecfg.mat)
        self.layer_map = meta.layer_map()
        self.moe_positions = list(meta.moe_positions)
        self.n_moe_layers = meta.n_moe_layers
        self.n_experts = meta.n_experts
        self.resident_bytes = meta.resident_bytes
        self.expert_macs_per_token = meta.expert_macs_per_token

        # Placement must exist before the cache: the sharded cache keys
        # slice ownership off the map.
        self.placement_policy = ecfg.build_placement_policy(
            self.n_moe_layers, self.n_experts)
        self.placement = (self.placement_policy.initial()
                          if self.placement_policy is not None else None)
        self._decode_steps = 0
        self.migration_events: List[dict] = []
        self.cache = ecfg.cache(placement=self.placement)
        self.ledger = ecfg.ledger()
        self.tracker = HotnessTracker(self.n_moe_layers, self.n_experts)
        self.requests_served = 0
        self.recorder = None
        # attach_tracer (inherited) wires a TimelineTracer through the
        # same ledgers the live engine uses, so a replay emits the
        # identical event stream.
        self.tracer = None
        self.prefetcher = ecfg.build_prefetcher(
            self.n_moe_layers, self.n_experts)
        self._pf_pending = {}

        # Closed-loop SLO controller: its bit/partition decisions consume
        # only charge-path counters, so the replayed decision sequence is
        # the live one.
        self.slo_controller = None
        if ecfg.controller is not None:
            self.slo_controller = SLOController(
                ecfg.controller, cache_bytes=ecfg.cache_bytes)

        # Open-loop controller (see module docstring): tracks what alpha
        # the live controller would command given the replayed miss
        # curve; it cannot bend the recorded routing.
        self.controller = self.new_controller()

        # accumulators
        self.wall_s = 0.0
        self.decode_wall_s = 0.0
        self._n_prefills = 0
        self._miss_curve: List[float] = []
        self._energy_curve: List[float] = []
        self._alpha_curve: List[float] = []
        self._decode_accesses = 0
        self._decode_misses = 0
        self._per_tenant_rows: List[dict] = []
        self._finished = False

    # --------------------------------------------------------- test hook
    def force_sharded(self, n_shards: int = 1) -> "ReplayEngine":
        """Swap in the expert-parallel cache/ledger machinery at an
        arbitrary shard count without touching the config.

        The charge path dispatches on the component types, so forcing
        ``n_shards=1`` runs the full sharded code over a single shard.
        Must be called before any event is consumed (it rebuilds cache
        and ledger empty).
        """
        if self.requests_served or self._miss_curve:
            raise RuntimeError("force_sharded must precede consumption")
        slice_aware = self.ecfg.policy.slice_mode == "dbsc" \
            and not self.ecfg.fused_slices
        if n_shards > 1:
            self.placement_policy = build_placement_policy(
                self.ecfg.placement, self.n_moe_layers, self.n_experts,
                n_shards,
                replicate_k=self.ecfg.replicate_k or None)
            self.placement = self.placement_policy.initial()
        else:
            self.placement_policy = None
            self.placement = None
        self.cache = ShardedSliceCache(self.ecfg.cache_bytes, n_shards,
                                       slice_aware=slice_aware,
                                       placement=self.placement)
        self.ledger = ShardedCostLedger(
            SYSTEM_PROFILES[self.ecfg.system], n_shards)
        if self.tracer is not None:   # re-wire the sink onto the new ledger
            self.attach_tracer(self.tracer)
        return self

    # ------------------------------------------------- disabled live API
    def run_prefill(self, *a, **k):          # pragma: no cover - guard
        raise TypeError("ReplayEngine is trace-driven; feed events via "
                        "consume()/replay_trace()")

    def decode_batch(self, *a, **k):         # pragma: no cover - guard
        raise TypeError("ReplayEngine is trace-driven; feed events via "
                        "consume()/replay_trace()")

    # ------------------------------------------------------------- replay
    def consume(self, event) -> None:
        """Replay one recorded event through the live charge path."""
        t0 = time.perf_counter()
        if event.kind == "prefill":
            self._begin_request(event.label, event.inflight,
                                tenant=getattr(event, "tenant", "default"))
            active = getattr(event, "active", None)
            self._charge_prefill(
                np.asarray(event.ids), np.asarray(event.gates),
                None if active is None else np.asarray(active, bool))
            self._finish_prefill(event.label)
            self.controller = self.new_controller()
            self._n_prefills += 1
        elif event.kind == "decode":
            slot_mask = np.asarray(event.slot_mask, bool)
            tr = _StepTrace(
                ids=np.asarray(event.ids),
                gates=np.asarray(event.gates, np.float64),
                active=np.asarray(event.active, bool),
                critical=np.asarray(event.critical, bool),
                slot_mask=slot_mask,
                slot_accesses=np.zeros(slot_mask.shape[0], np.int64),
                slot_misses=np.zeros(slot_mask.shape[0], np.int64),
                slot_tenants=getattr(event, "slot_tenants", None))
            charge = self.charge_step_trace(tr)
            self._miss_curve.append(charge.miss_rate)
            self._energy_curve.append(
                charge.ledger_delta["total_energy_j"])
            self._decode_accesses += charge.accesses
            self._decode_misses += charge.misses
            if charge.per_tenant is not None:
                self._per_tenant_rows.append(charge.per_tenant)
            alpha = 0.0
            if self.controller is not None:
                alpha = self.controller.update(charge.miss_rate)
            self._alpha_curve.append(alpha)
        else:                                # pragma: no cover - guard
            raise ValueError(f"unknown trace event kind {event.kind!r}")
        dt = time.perf_counter() - t0
        self.wall_s += dt
        if event.kind == "decode":
            self.decode_wall_s += dt

    def consume_all(self, events: Iterable[Any]) -> "ReplayEngine":
        for ev in events:
            self.consume(ev)
        return self

    def finish(self) -> "ReplayReport":
        """Flush the open stats epoch and build the report."""
        if not self._finished:
            self._prefetch_flush()   # settle never-used pending fills
            self.cache.end_epoch()
            self._finished = True
        return self.report()

    def report(self) -> "ReplayReport":
        return ReplayReport(
            n_prefills=self._n_prefills,
            n_decode_steps=len(self._miss_curve),
            miss_curve=list(self._miss_curve),
            energy_curve=list(self._energy_curve),
            decode_accesses=self._decode_accesses,
            decode_misses=self._decode_misses,
            epoch_miss=self.cache.epoch_miss_rates(),
            epoch_counts=self.cache.epoch_counts(),
            ledger=self.ledger.snapshot(),
            prefetch=(self.prefetcher.summary()
                      if self.prefetcher is not None else None),
            alpha_curve=list(self._alpha_curve),
            wall_s=self.wall_s,
            decode_wall_s=self.decode_wall_s,
            per_shard_epoch_counts=(
                self.cache.per_shard_epoch_counts()
                if isinstance(self.cache, ShardedSliceCache) else None),
            per_tenant_rows=(list(self._per_tenant_rows)
                             if self._per_tenant_rows else None),
            controller_summary=(self.slo_controller.summary()
                                if self.slo_controller is not None
                                else None),
            migration_events=(list(self.migration_events)
                              if self.migration_events else None),
            placement=self.placement_summary())

    # --------------------------------------------------------------- fork
    def clone(self) -> "ReplayEngine":
        """Fork the simulation: an independent engine continuing from the
        exact current state.  Immutable pieces (meta, byte store, config)
        are shared; all mutable simulation state is deep-copied via the
        components' own ``clone()`` methods."""
        new = object.__new__(ReplayEngine)
        new.__dict__.update(self.__dict__)
        new.cache = self.cache.clone()
        new.ledger = self.ledger.clone()
        new.tracker = self.tracker.clone()
        new.prefetcher = (self.prefetcher.clone()
                          if self.prefetcher is not None else None)
        # In-flight prefetch bookkeeping is engine state, not predictor
        # state — fork it so the clone's judgments don't drain ours.
        new._pf_pending = {l: dict(m)
                           for l, m in self._pf_pending.items()}
        new.controller = copy.deepcopy(self.controller)
        new.slo_controller = copy.deepcopy(self.slo_controller)
        new.recorder = None
        new.tracer = None   # ledger.clone() already detached its sink
        for f in ("_miss_curve", "_energy_curve", "_alpha_curve",
                  "_per_tenant_rows", "migration_events",
                  "moe_positions"):
            setattr(new, f, list(getattr(self, f)))
        return new


def replay_trace(trace: Trace, ecfg: Optional[EngineConfig] = None,
                 *, max_events: Optional[int] = None,
                 **overrides) -> ReplayReport:
    """One-shot replay of ``trace`` (optionally truncated) under the
    recorded config or an overridden one.  Returns the report."""
    eng = ReplayEngine(trace.meta, ecfg, **overrides)
    events = trace.events if max_events is None \
        else trace.events[:max_events]
    eng.consume_all(events)
    return eng.finish()
