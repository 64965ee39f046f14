"""Routing-trace schema, recorder and (de)serialization (port of
``repro.sim.trace``, numpy only).

A **trace** is the complete model-free record of one serving run: for
every prefill and every decode step, the per-layer routing arrays the
engine's charge path consumes (expert ids, gates, active/critical masks,
slot mask), plus a :class:`TraceMeta` header carrying everything the
replay simulator needs to rebuild byte sizes and cost constants without
a model — weight-slice shapes, resident bytes, MAC counts and the
recorded :class:`~repro_torch.core.engine.EngineConfig` knobs.

Event stream (execution order, exactly as the live engine charged it):

* :class:`PrefillEvent` — one admitted request's prompt routing
  ``ids/gates [n_periods, n_moe_pos, T, k]`` plus the request-boundary
  inputs (``label``, ``inflight``) that drive hotness aging and cache
  stats epochs.
* :class:`DecodeEvent` — one batched decode step's routing
  ``ids/gates/active/critical [n_periods, n_moe_pos, T, k]`` and the
  ``slot_mask [T]`` of live slots.

Because the replay simulator feeds these arrays through the *same*
``_charge_prefill`` / ``charge_step_trace`` code the live engine runs,
replaying a trace under the recorded config reproduces the live run's
per-epoch miss counts exactly and its energy/latency bit-for-bit.

Serialization: ``.npz`` (compact, exact) and ``.jsonl`` (line-oriented,
diffable; floats round-trip exactly via ``repr``).  The formats are the
reference's: either package reads a trace the other wrote.

Recording a live run::

    rec = TraceRecorder()
    sched = ContinuousBatchingScheduler(engine, cfg)
    sched.attach_recorder(rec)          # or rec.attach(engine)
    ... submit / run ...
    rec.trace().save("run.npz")
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

TRACE_VERSION = 1

__all__ = [
    "TRACE_VERSION", "TraceMeta", "PrefillEvent", "DecodeEvent", "Trace",
    "TraceRecorder", "engine_meta", "traces_equal",
]


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceMeta:
    """Model-free replay header: topology, byte-size inputs, config.

    ``wi_shape``/``wo_shape`` are the per-expert quantized code shapes —
    with ``group_size`` they let the replay recompute MSB/LSB slice bytes
    for *any* AMAT bit plan (the autotuner's bit-plan axis), via the same
    :func:`repro_torch.core.amat.slice_nbytes` the live store uses.
    ``engine`` is the recorded EngineConfig as a flat dict; it is the
    replay default, and the knob set the autotuner overrides.
    """

    model: str
    d_model: int
    n_periods: int
    moe_positions: Tuple[int, ...]
    n_moe_layers: int
    n_experts: int
    top_k: int
    group_size: int
    wi_shape: Tuple[int, ...]
    wo_shape: Tuple[int, ...]
    resident_bytes: float
    expert_macs_per_token: int
    engine: Dict[str, Any]
    version: int = TRACE_VERSION

    def layer_map(self) -> Dict[Tuple[int, int], int]:
        """(position, period) -> flat moe layer index, in execution
        order — the same enumeration ``quantize_moe_params`` builds."""
        out = {}
        flat = 0
        for period in range(self.n_periods):
            for pos in self.moe_positions:
                out[(pos, period)] = flat
                flat += 1
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceMeta":
        d = dict(d)
        for f in ("moe_positions", "wi_shape", "wo_shape"):
            d[f] = tuple(int(x) for x in d[f])
        return cls(**d)


@dataclasses.dataclass
class PrefillEvent:
    """One admitted request's prompt routing + boundary metadata.

    ``active`` (optional, None = every slot) records the routing
    policy's slot-activation mask — under cumsum prefill most of the
    ``k_max`` slots are deactivated and the charge path must skip them.
    Traces recorded before the field existed load with ``active=None``
    and replay as all-active, exactly as they were charged live.
    """

    ids: np.ndarray            # [n_periods, n_moe_pos, T, k] int
    gates: np.ndarray          # float64, same shape
    active: Optional[np.ndarray] = None    # bool, same shape (or None)
    label: Optional[str] = None
    inflight: int = 0
    request_id: Optional[int] = None
    tenant: str = "default"

    kind = "prefill"
    _array_fields = ("ids", "gates", "active")
    _optional_array_fields = ("active",)   # absent in pre-EP traces


@dataclasses.dataclass
class DecodeEvent:
    """One batched decode step's routing arrays.

    ``slot_tenants`` (optional) carries per-slot tenant attribution —
    the SLO controller's input signal.  It records the step's *inputs*
    only; the controller's bit plan is deliberately NOT recorded, so a
    replay recomputes it from the same stream (the control-loop
    fidelity gate).  Pre-controller traces load with ``None``.
    """

    ids: np.ndarray            # [n_periods, n_moe_pos, T, k] int
    gates: np.ndarray          # float64
    active: np.ndarray         # bool
    critical: np.ndarray       # bool
    slot_mask: np.ndarray      # [T] bool
    slot_tenants: Optional[List] = None    # [T] tenant names / None

    kind = "decode"
    _array_fields = ("ids", "gates", "active", "critical", "slot_mask")


_EVENT_TYPES = {"prefill": PrefillEvent, "decode": DecodeEvent}
_ARRAY_DTYPES = {"ids": np.int32, "gates": np.float64, "active": bool,
                 "critical": bool, "slot_mask": bool}


@dataclasses.dataclass
class Trace:
    """Header + ordered event stream of one recorded (or synthetic) run."""

    meta: TraceMeta
    events: List[Any] = dataclasses.field(default_factory=list)

    # ----------------------------------------------------------- counters
    @property
    def n_prefills(self) -> int:
        return sum(1 for e in self.events if e.kind == "prefill")

    @property
    def n_decode_steps(self) -> int:
        return sum(1 for e in self.events if e.kind == "decode")

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------ serialization
    def save(self, path: str) -> str:
        """Write by extension: ``.npz`` or ``.jsonl``."""
        if path.endswith(".npz"):
            return self.save_npz(path)
        if path.endswith(".jsonl"):
            return self.save_jsonl(path)
        raise ValueError(f"unknown trace format for {path!r} "
                         "(want .npz or .jsonl)")

    @classmethod
    def load(cls, path: str) -> "Trace":
        if path.endswith(".npz"):
            return cls.load_npz(path)
        if path.endswith(".jsonl"):
            return cls.load_jsonl(path)
        raise ValueError(f"unknown trace format for {path!r} "
                         "(want .npz or .jsonl)")

    def save_npz(self, path: str) -> str:
        arrays: Dict[str, np.ndarray] = {}
        scalars: List[dict] = []
        for i, ev in enumerate(self.events):
            sc = {"kind": ev.kind}
            for f in dataclasses.fields(ev):
                v = getattr(ev, f.name)
                if f.name in ev._array_fields:
                    if v is None:        # optional array (e.g. active)
                        continue
                    arrays[f"e{i:06d}_{f.name}"] = np.asarray(
                        v, _ARRAY_DTYPES[f.name])
                else:
                    sc[f.name] = v
            scalars.append(sc)
        np.savez_compressed(
            path,
            meta_json=np.str_(json.dumps(self.meta.to_dict())),
            events_json=np.str_(json.dumps(scalars)),
            **arrays)
        return path

    @classmethod
    def load_npz(cls, path: str) -> "Trace":
        with np.load(path, allow_pickle=False) as z:
            meta = TraceMeta.from_dict(json.loads(str(z["meta_json"])))
            scalars = json.loads(str(z["events_json"]))
            events = []
            for i, sc in enumerate(scalars):
                etype = _EVENT_TYPES[sc.pop("kind")]
                optional = getattr(etype, "_optional_array_fields", ())
                kw = dict(sc)
                for f in etype._array_fields:
                    name = f"e{i:06d}_{f}"
                    if name in z.files:
                        kw[f] = np.asarray(z[name], _ARRAY_DTYPES[f])
                    elif f not in optional:
                        # fail fast with the missing array's name (a
                        # truncated/corrupt file), as before the
                        # optional-field support landed
                        kw[f] = np.asarray(z[name], _ARRAY_DTYPES[f])
                    # absent optional arrays keep their None default
                events.append(etype(**kw))
        return cls(meta=meta, events=events)

    def save_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(json.dumps({"type": "meta", **self.meta.to_dict()})
                    + "\n")
            for ev in self.events:
                line: Dict[str, Any] = {"type": ev.kind}
                for fld in dataclasses.fields(ev):
                    v = getattr(ev, fld.name)
                    if fld.name in ev._array_fields:
                        # tolist(): Python scalars; float repr round-trips
                        # exactly through json, keeping jsonl==npz parity.
                        line[fld.name] = None if v is None \
                            else np.asarray(v).tolist()
                    else:
                        line[fld.name] = v
                f.write(json.dumps(line) + "\n")
        return path

    @classmethod
    def load_jsonl(cls, path: str) -> "Trace":
        meta = None
        events = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                t = d.pop("type")
                if t == "meta":
                    meta = TraceMeta.from_dict(d)
                    continue
                etype = _EVENT_TYPES[t]
                optional = getattr(etype, "_optional_array_fields", ())
                for fld in etype._array_fields:
                    if fld in optional and d.get(fld) is None:
                        continue        # absent/null: keep None default
                    d[fld] = np.asarray(d[fld], _ARRAY_DTYPES[fld])
                events.append(etype(**d))
        if meta is None:
            raise ValueError(f"{path}: no meta line")
        return cls(meta=meta, events=events)


def traces_equal(a: Trace, b: Trace) -> bool:
    """Exact structural equality (meta, event order, arrays, scalars)."""
    if a.meta.to_dict() != b.meta.to_dict() or len(a) != len(b):
        return False
    for ea, eb in zip(a.events, b.events):
        if ea.kind != eb.kind:
            return False
        for f in dataclasses.fields(ea):
            va, vb = getattr(ea, f.name), getattr(eb, f.name)
            if f.name in ea._array_fields:
                if (va is None) != (vb is None):
                    return False
                if va is not None and not np.array_equal(
                        np.asarray(va), np.asarray(vb)):
                    return False
            elif va != vb:
                return False
    return True


# --------------------------------------------------------------------------
# recorder
# --------------------------------------------------------------------------
def engine_meta(engine) -> TraceMeta:
    """Build the replay header from a live :class:`PersistentEngine`."""
    ecfg = engine.ecfg
    first = engine.store.layers[min(engine.store.layers)]
    return TraceMeta(
        model=engine.cfg.name,
        d_model=int(engine.cfg.d_model),
        n_periods=int(engine.cfg.n_periods),
        moe_positions=tuple(int(p) for p in engine.moe_positions),
        n_moe_layers=int(engine.n_moe_layers),
        n_experts=int(engine.n_experts),
        top_k=int(engine.cfg.moe.top_k),
        group_size=int(ecfg.mat.group_size),
        wi_shape=tuple(int(x) for x in first.wi_q.codes.shape[1:]),
        wo_shape=tuple(int(x) for x in first.wo_q.codes.shape[1:]),
        resident_bytes=float(engine.resident_bytes),
        expert_macs_per_token=int(engine.expert_macs_per_token),
        engine={
            "high_bits": ecfg.mat.high_bits,
            "low_bits": ecfg.mat.low_bits,
            "cache_bytes": ecfg.cache_bytes,
            "policy_kind": ecfg.policy.kind,
            "slice_mode": ecfg.policy.slice_mode,
            "theta": ecfg.policy.theta,
            "fetch_lsb_on_miss": ecfg.policy.fetch_lsb_on_miss,
            "miss_rate_target": ecfg.miss_rate_target,
            "warmup": ecfg.warmup,
            "lsb_keep_frac": ecfg.lsb_keep_frac,
            "system": ecfg.system,
            "fused_slices": ecfg.fused_slices,
            "prefetch_top_m": ecfg.prefetch_top_m,
            "async_io": ecfg.async_io,
            "hotness_request_decay": ecfg.hotness_request_decay,
            "ep_shards": ecfg.ep_shards,
            "prefetch_min_obs": ecfg.prefetch_min_obs,
            "prefetch_kind": ecfg.prefetch_kind,
            "prefetch_lookahead": ecfg.prefetch_lookahead,
            "prefetch_min_score": ecfg.prefetch_min_score,
            "controller": (None if ecfg.controller is None
                           else ecfg.controller.to_dict()),
            "placement": ecfg.placement,
            "placement_period": ecfg.placement_period,
            "replicate_k": ecfg.replicate_k,
        },
    )


class TraceRecorder:
    """Lightweight engine hook capturing the replayable event stream.

    Attach with :meth:`attach` (or
    ``ContinuousBatchingScheduler.attach_recorder``); the engine then
    calls :meth:`on_prefill` / :meth:`on_decode` at exactly the points
    its charge path consumes the same arrays, so the recorded order *is*
    the charged order — the property the fidelity gate relies on.
    """

    def __init__(self, engine=None):
        self.meta: Optional[TraceMeta] = None
        self.events: List[Any] = []
        if engine is not None:
            self.attach(engine)

    def attach(self, engine) -> "TraceRecorder":
        self.meta = engine_meta(engine)
        engine.recorder = self
        return self

    # ----------------------------------------------------------- callbacks
    def on_prefill(self, ids: np.ndarray, gates: np.ndarray, *,
                   active: Optional[np.ndarray] = None,
                   label: Optional[str] = None, inflight: int = 0,
                   tenant: str = "default") -> None:
        self.events.append(PrefillEvent(
            ids=np.array(ids, _ARRAY_DTYPES["ids"]),
            gates=np.array(gates, _ARRAY_DTYPES["gates"]),
            active=(None if active is None
                    else np.array(active, _ARRAY_DTYPES["active"])),
            label=label, inflight=int(inflight), tenant=tenant))

    def on_decode(self, tr) -> None:
        """``tr``: the engine's ``_StepTrace`` (pre-charge, pre-plan)."""
        self.events.append(DecodeEvent(
            ids=np.array(tr.ids, _ARRAY_DTYPES["ids"]),
            gates=np.array(tr.gates, _ARRAY_DTYPES["gates"]),
            active=np.array(tr.active, bool),
            critical=np.array(tr.critical, bool),
            slot_mask=np.array(tr.slot_mask, bool),
            slot_tenants=(None if tr.slot_tenants is None
                          else list(tr.slot_tenants))))

    def annotate_prefill(self, *, request_id: Optional[int] = None,
                         tenant: Optional[str] = None) -> None:
        """Attach request metadata to the most recent prefill event
        (called by the scheduler, which knows the Request object)."""
        for ev in reversed(self.events):
            if ev.kind == "prefill":
                if request_id is not None:
                    ev.request_id = int(request_id)
                if tenant is not None:
                    ev.tenant = tenant
                return

    # -------------------------------------------------------------- output
    def trace(self) -> Trace:
        if self.meta is None:
            raise ValueError("recorder was never attached to an engine")
        return Trace(meta=self.meta, events=list(self.events))
