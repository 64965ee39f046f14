"""Continuous-batching scheduler over a persistent SliceMoE engine
(port of ``repro.serving.scheduler``).

Requests are admitted into a fixed pool of ``max_batch`` decode *slots*;
prefills interleave with batched decode steps over all active slots, and
sequences retire individually on EOS or their token budget.  The engine
— slice cache, hotness tracker, cost ledger — persists across every
request, so steady-state traffic runs against a warm cache.

One ``step()``: admission (while a slot is free and the queue head has
arrived on the simulated clock: prefill it and install its KV cache in
the slot), one batched decode step over all slots with padding slots
masked, then per-sequence retirement.

The simulated clock is the cost ledger's latency, so admission timing,
TTFT and throughput are deterministic functions of the workload and the
modeled hardware.  Wall seconds (host clock) are reported separately on
each :class:`Completion`.

``attach_recorder`` records the run's routing trace for offline replay
(:mod:`repro_torch.sim`).  ``SchedulerConfig.admission_hook`` gates
admission; an engine's SLO controller is wired into the telemetry and,
absent a hook, into admission.  ``attach_metrics`` samples a
:class:`~repro_torch.obs.metrics.MetricsRegistry` per decode step, and an
engine with a timeline tracer attached gets the request and step spans.
Each ``step()`` opens one record of the host-clock spans in
``self.spans`` (:mod:`repro_torch.obs.spans`), and the decode step's own
host work is three of them: ``slicemoe.sched.prepare``, ``.sample`` and
``.update``.
``SchedulerConfig.truncate_prompts`` admits over-budget prompts clipped
to their tail, and ``bucket_prompts`` rounds admitted prompts down to a
multiple of its length; a clipped request is flagged ``truncated`` on
telemetry.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import PersistentEngine
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsSampler
from repro_torch.obs.spans import SPANS, close_step, span
from repro_torch.serving.telemetry import (FleetTelemetry, RequestRecord,
                                           StepRecord)


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    arrival_time: float = 0.0     # simulated seconds
    tenant: str = "default"


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: np.ndarray
    prefill_s: float              # wall seconds (host)
    decode_s: float
    metrics: Optional[dict] = None


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 4
    max_queue: int = 64
    # Truncate prompts down to a multiple of this many tokens (0 = exact
    # lengths).  Bounds the number of distinct prefill shapes under
    # length-diverse workloads.  Setting this is itself explicit consent
    # to (up to bucket_prompts-1 tokens of) truncation: it applies to
    # admitted prompts regardless of `truncate_prompts`, and clipped
    # requests are flagged on telemetry either way.
    bucket_prompts: int = 0
    # Admit over-budget prompts by clipping them to the KV budget
    # (keeping the tail, recorded on telemetry as ``truncated``).  Off by
    # default: the output for a clipped request is not the output for
    # the full prompt, so silent truncation must be opted into;
    # otherwise admission rejects any request whose full token budget
    # (prompt + max_new_tokens) cannot fit under ``max_seq``.
    truncate_prompts: bool = False
    # Admission-control hook: called with the Request at submit time;
    # returning False rejects it (recorded on telemetry like any other
    # rejection).  When None and the engine carries an SLO controller
    # (EngineConfig.controller), the controller's admit_request is wired
    # in automatically.
    admission_hook: Optional[Callable[["Request"], bool]] = None


@dataclasses.dataclass
class ActiveSeq:
    """Per-request state pinned to one decode slot."""

    slot: int
    request: Request
    record: RequestRecord
    controller: object                 # MissRateController | None
    alpha: float = 0.0
    last_token: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    ledger_base: Optional[dict] = None # snapshot at decode start
    wall_prefill_s: float = 0.0
    wall_decode_t0: float = 0.0
    prefill_end_t: float = 0.0         # sim clock when prefill settled


class ContinuousBatchingScheduler:
    """Admission control + continuous batching over a PersistentEngine.

    Runs on ``device`` (``cuda`` unless told otherwise), which must be the
    engine's device.
    """

    def __init__(self, engine: PersistentEngine,
                 cfg: Optional[SchedulerConfig] = None, *, device=None):
        dev = resolve_device(device)
        if dev.type != engine.device.type or (
                dev.index is not None and dev != engine.device):
            raise ValueError(f"scheduler on {dev}, engine on {engine.device}")
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        if self.cfg.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[ActiveSeq]] = [None] * self.cfg.max_batch
        self.batch_cache = engine.init_batch_cache(self.cfg.max_batch)
        self.telemetry = FleetTelemetry()
        self.completions: List[Completion] = []
        self.sim_time = 0.0
        self._ledger_mark = engine.ledger.total_latency_s
        self._admission_hook = self.cfg.admission_hook
        ctl = engine.slo_controller
        if ctl is not None:
            # Close the loop: the controller reads live telemetry (TTFT,
            # step records) and, absent an explicit hook, gates admission.
            ctl.attach_telemetry(self.telemetry)
            if self._admission_hook is None:
                self._admission_hook = ctl.admit_request
        # Host wall seconds of each prefill and each decode step, measured
        # after the device finished (a synchronize ends each span).
        self.wall_prefill_s: List[float] = []
        self.wall_step_s: List[float] = []
        # Record k of self.spans is this scheduler's step k: the
        # process-wide SPANS where no other live scheduler holds it.
        self.spans = SPANS.claim(self)

    def attach_recorder(self, recorder):
        """Wire a :class:`repro_torch.sim.trace.TraceRecorder` into the
        engine.  The engine hooks capture the replayable routing arrays;
        the scheduler additionally annotates each prefill event with the
        request id and tenant, which only it knows.  Returns the
        recorder for chaining."""
        return recorder.attach(self.engine)

    def attach_metrics(self, registry):
        """Sample a :class:`repro_torch.obs.metrics.MetricsRegistry` per
        decode step: registers a :class:`~repro_torch.obs.metrics.
        MetricsSampler` as a telemetry listener (the mechanism the SLO
        controller rides), folding each StepRecord plus engine-side state
        (cache occupancy, ledger traffic, prefetch outcomes, controller
        actuation) into one catalog.  Returns the registry."""
        self.telemetry.add_listener(MetricsSampler(registry, self.engine))
        return registry

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    # --------------------------------------------------------------- intake
    def servable(self, req: Request) -> bool:
        """Whether the request's *full* token budget fits the KV budget
        (``len(prompt) + max_new_tokens + 1 <= max_seq``).  With
        ``truncate_prompts`` the prompt side is waived: admission clips
        it to the budget and flags the request.  (``bucket_prompts``
        rounding is a separate, explicit opt-in and still applies to
        admitted prompts.)"""
        max_seq = self.engine.ecfg.max_seq
        if not 1 <= req.max_new_tokens < max_seq - 1:
            return False
        if self.cfg.truncate_prompts:
            return True
        return len(req.prompt) + req.max_new_tokens + 1 <= max_seq

    def submit(self, req: Request) -> bool:
        """Admission control: reject queue overflow, unservable sizes and
        requests the admission hook refuses."""
        record = RequestRecord(
            request_id=req.request_id, tenant=req.tenant,
            prompt_len=len(req.prompt), arrival_t=req.arrival_time)
        if len(self.queue) >= self.cfg.max_queue or not self.servable(req):
            self.telemetry.on_reject(record)
            return False
        if self._admission_hook is not None \
                and not self._admission_hook(req):
            self.telemetry.on_reject(record)
            return False
        self.telemetry.on_submit(record)
        self.queue.append(req)
        return True

    # ---------------------------------------------------------------- clock
    def _advance_clock(self) -> float:
        """Fold new ledger latency into the simulated clock; return delta."""
        now = self.engine.ledger.total_latency_s
        delta = now - self._ledger_mark
        self._ledger_mark = now
        self.sim_time += delta
        return delta

    # ------------------------------------------------------------ admission
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _clip_prompt(self, req: Request) -> np.ndarray:
        """Fit the prompt under the KV budget (keeping its tail).

        Truncation is recorded on the request's telemetry record and in
        its completion metrics: the output for a clipped request is not
        the output for the full prompt.
        """
        prompt = np.asarray(req.prompt, np.int32)
        budget = self.engine.ecfg.max_seq - req.max_new_tokens - 1
        if budget < 1:
            raise ValueError(
                f"request {req.request_id}: max_new_tokens="
                f"{req.max_new_tokens} leaves no room for a prompt under "
                f"max_seq={self.engine.ecfg.max_seq}")
        if len(prompt) > budget:
            prompt = prompt[-budget:]
        q = self.cfg.bucket_prompts
        if q > 1 and len(prompt) > q:
            # Round down to a multiple of q, keeping the most recent
            # tokens (the same tail-keep rule as the budget clip above).
            prompt = prompt[-(len(prompt) // q) * q:]
        if len(prompt) != len(req.prompt):
            self.telemetry.requests[req.request_id].truncated = True
        return prompt

    def _admit_one(self, req: Request, slot: int) -> None:
        record = self.telemetry.requests[req.request_id]
        record.admit_t = self.sim_time
        t0 = time.perf_counter()
        prompt = self._clip_prompt(req)
        # Per-request stats epochs are only meaningful one request at a
        # time; under batching concurrent sequences would share them.
        label = f"req{req.request_id}" if self.cfg.max_batch == 1 else None
        logits, kv_cache, _info = self.engine.run_prefill(
            prompt[None], label=label, inflight=self.n_active(),
            tenant=req.tenant)
        if self.engine.recorder is not None:
            self.engine.recorder.annotate_prefill(
                request_id=req.request_id, tenant=req.tenant)
        last_token = int(torch.argmax(logits, dim=-1)[0])
        self._sync()
        wall = time.perf_counter() - t0
        self.wall_prefill_s.append(wall)
        self._advance_clock()
        trc = self.engine.tracer
        if trc is not None:
            # Admission spans on the request's own track, in the same
            # sim-clock coordinates as the channel events.
            track = f"req{req.request_id}"
            trc.span("queue", track, record.arrival_t, record.admit_t,
                     request=req.request_id, tenant=req.tenant,
                     queue_delay_s=record.admit_t - record.arrival_t)
            trc.span("prefill", track, record.admit_t, self.sim_time,
                     request=req.request_id, slot=slot,
                     prompt_len=len(prompt))
        seq = ActiveSeq(
            slot=slot, request=req, record=record,
            controller=self.engine.new_controller(),
            last_token=last_token,
            ledger_base=self.engine.ledger.snapshot(),
            wall_prefill_s=wall,
            wall_decode_t0=time.perf_counter(),
            prefill_end_t=self.sim_time)
        self.batch_cache = self.engine.install_slot(
            self.batch_cache, kv_cache, slot)
        self.slots[slot] = seq

    def _admit(self) -> int:
        admitted = 0
        free = self._free_slots()
        while free and self.queue:
            req = self.queue[0]
            if req.arrival_time > self.sim_time:
                if self.n_active() == 0 and admitted == 0:
                    self.sim_time = req.arrival_time   # idle: fast-forward
                else:
                    break
            self.queue.popleft()
            self._admit_one(req, free.pop(0))
            admitted += 1
        return admitted

    # --------------------------------------------------------------- decode
    def _decode_step(self) -> None:
        active = [s for s in self.slots if s is not None]
        if not active:
            return
        t0 = time.perf_counter()
        with span("slicemoe.sched.prepare"):
            tokens = np.zeros(self.cfg.max_batch, np.int64)
            slot_mask = np.zeros(self.cfg.max_batch, bool)
            slot_tenants: List[Optional[str]] = [None] * self.cfg.max_batch
            for seq in active:
                tokens[seq.slot] = seq.last_token
                slot_mask[seq.slot] = True
                slot_tenants[seq.slot] = seq.request.tenant
            alpha = float(np.mean([seq.alpha for seq in active]))
            step_t0 = self.sim_time
            token = torch.as_tensor(tokens, device=self.engine.device)

        logits, self.batch_cache, charge = self.engine.decode_batch(
            token, self.batch_cache, alpha=alpha, slot_active=slot_mask,
            slot_tenants=slot_tenants)
        with span("slicemoe.sched.sample"):
            next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
            self._sync()
        self.wall_step_s.append(time.perf_counter() - t0)
        with span("slicemoe.sched.update"):
            step_latency = self._advance_clock()
            trc = self.engine.tracer
            if trc is not None:
                # One span per batched decode step on the shared steps
                # track; trc.step is the engine's step index, the id every
                # channel event of this step carries.
                trc.span("decode_step", "steps", step_t0, self.sim_time,
                         step=trc.step, n_active=len(active),
                         miss_rate=charge.miss_rate)
            self.telemetry.on_step(StepRecord(
                t=self.sim_time, n_active=len(active),
                miss_rate=charge.miss_rate, latency_s=step_latency,
                energy_j=charge.ledger_delta["total_energy_j"],
                io_stall_s=max(0.0, charge.ledger_delta.get("io_stall_s",
                                                            0.0)),
                overlap_saved_s=max(0.0, charge.ledger_delta.get(
                    "overlap_saved_s", 0.0)),
                per_tenant=charge.per_tenant))

            for seq in active:
                tok = int(next_tokens[seq.slot])
                seq.generated.append(tok)
                seq.last_token = tok
                if len(seq.generated) == 1:
                    seq.record.first_token_t = self.sim_time
                    self.telemetry.on_first_token(seq.record)
                seq.record.n_generated = len(seq.generated)
                slot_miss = float(charge.per_slot_miss[seq.slot])
                seq.record.miss_sum += slot_miss
                seq.record.miss_steps += 1
                if seq.controller is not None:
                    seq.alpha = seq.controller.update(slot_miss)
                done = len(seq.generated) >= seq.request.max_new_tokens or \
                    (seq.request.eos_token is not None
                     and tok == seq.request.eos_token)
                if done:
                    self._retire(seq)

    def _retire(self, seq: ActiveSeq) -> None:
        seq.record.finish_t = self.sim_time
        trc = self.engine.tracer
        if trc is not None:
            rid = seq.request.request_id
            track = f"req{rid}"
            trc.span("decode", track, seq.prefill_end_t, self.sim_time,
                     request=rid, n_tokens=len(seq.generated),
                     ttft_s=seq.record.ttft,
                     queue_delay_s=seq.record.queue_delay)
            trc.span("retire", track, self.sim_time, self.sim_time,
                     request=rid)
        self.completions.append(Completion(
            request_id=seq.request.request_id,
            tokens=np.asarray(seq.generated, np.int32),
            prefill_s=seq.wall_prefill_s,
            decode_s=time.perf_counter() - seq.wall_decode_t0,
            metrics={
                "ttft_s": seq.record.ttft,
                "queue_delay_s": seq.record.queue_delay,
                "mean_miss_rate": seq.record.mean_miss_rate,
                "alpha_final": seq.alpha,
                "prompt_truncated": seq.record.truncated,
                # Exact for max_batch=1; overlaps concurrent requests
                # otherwise (fleet totals live in telemetry.summary()).
                "decode_totals": self.engine.ledger.delta_since(
                    seq.ledger_base),
                # Likewise: the current stats window, per-request only
                # when requests run one at a time.
                "cache_stats": self.engine.cache.stats.snapshot(),
            }))
        self.slots[seq.slot] = None
        self.batch_cache = self.engine.clear_slot(self.batch_cache, seq.slot)

    # ------------------------------------------------------------------ run
    def step(self) -> bool:
        """One scheduler tick.  Returns False when fully idle."""
        self.spans.open_step()
        try:
            self._admit()
            if self.n_active() == 0:
                return bool(self.queue)
            self._decode_step()
            return True
        finally:
            close_step()

    def run(self) -> List[Completion]:
        """Drive until the queue drains and every sequence retires."""
        while self.step():
            pass
        self.engine._prefetch_flush()   # settle never-used pending fills
        self.engine.cache.end_epoch()   # flush the last request's window
        return self.completions

    def summary(self, **kw) -> dict:
        kw.setdefault("per_shard", self.engine.shard_breakdown())
        kw.setdefault("placement", self.engine.placement_summary())
        if self.engine.prefetcher is not None:
            kw.setdefault("prefetch", self.engine.prefetcher.summary())
        return self.telemetry.summary(
            total_energy_j=self.engine.ledger.total_energy_j, **kw)
