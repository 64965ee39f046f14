"""Single-batch serving API (port of ``repro.serving.server``).

:class:`SliceMoEServer` keeps the submit/run interface as a thin wrapper
over the continuous-batching scheduler run with ``max_batch=1``: requests
drain FIFO, one at a time, through a *persistent* engine, so the slice
cache and hotness statistics stay warm across requests.  Trace recording
(:meth:`SliceMoEServer.attach_recorder`), timeline tracing
(:meth:`~SliceMoEServer.attach_tracer`, :meth:`~SliceMoEServer.export_trace`)
and metrics sampling (:meth:`~SliceMoEServer.attach_metrics`) wire into
that engine and the scheduler of each run.

The reference's cold path (``persistent=False``: a fresh engine per
request) and serving a model without MoE layers (``PlainEngine``) wait
for ROADMAP.md queue 1, 'serving extras'.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineConfig, PersistentEngine
from repro_torch.device import resolve_device
from repro_torch.serving.scheduler import (Completion, ContinuousBatchingScheduler,
                                           Request, SchedulerConfig)

__all__ = ["Request", "Completion", "SliceMoEServer"]


class SliceMoEServer:
    """Runs on ``device`` (``cuda`` unless told otherwise)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 engine_cfg: EngineConfig, max_seq: int = 256, *,
                 persistent: bool = True, device=None):
        if not cfg.has_moe or engine_cfg is None or not persistent:
            raise NotImplementedError(
                "serving without the SliceMoE engine (PlainEngine) and the "
                "fresh-engine-per-request path are not ported yet "
                "(ROADMAP.md queue 1, 'serving extras')")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.engine_cfg = engine_cfg
        self.queue: Deque[Request] = deque()
        self.completions: List[Completion] = []
        self._engine: Optional[PersistentEngine] = None
        self._recorder = None
        self._tracer = None
        self._metrics = None
        # The scheduler behind the most recent run() (telemetry access).
        self.last_scheduler = None

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def attach_tracer(self, tracer):
        """Capture the engine's charge-path timeline.  The tracer wires
        into the shared engine as soon as it exists; export with
        :meth:`export_trace` after :meth:`run`."""
        self._tracer = tracer
        if self._engine is not None:
            self._engine.attach_tracer(tracer)
        return tracer

    def export_trace(self, path: str) -> dict:
        if self._engine is None or self._tracer is None:
            raise ValueError("no traced run: call attach_tracer() "
                             "before run()")
        return self._engine.export_trace(path)

    def attach_metrics(self, registry):
        """Sample the metrics registry per decode step; the sampler wires
        into the scheduler each :meth:`run` builds."""
        self._metrics = registry
        return registry

    def attach_recorder(self, recorder):
        """Record the served traffic's routing trace.  The recorder wires
        into the shared engine as soon as it exists."""
        self._recorder = recorder
        if self._engine is not None:
            recorder.attach(self._engine)
        return recorder

    def _shared_engine(self) -> PersistentEngine:
        if self._engine is None:
            ecfg = dataclasses.replace(self.engine_cfg, max_seq=self.max_seq)
            self._engine = PersistentEngine(self.cfg, self.params, ecfg,
                                            device=self.device)
            if self._recorder is not None:
                self._recorder.attach(self._engine)
            if self._tracer is not None:
                self._engine.attach_tracer(self._tracer)
        return self._engine

    def run(self) -> List[Completion]:
        """Drain the queue FIFO, one request at a time (single-batch)."""
        sched = ContinuousBatchingScheduler(
            self._shared_engine(),
            SchedulerConfig(max_batch=1, max_queue=len(self.queue) + 1),
            device=self.device)
        if self._metrics is not None:
            sched.attach_metrics(self._metrics)
        self.last_scheduler = sched
        # Validate the whole queue before draining any of it.
        bad = [r for r in self.queue if not sched.servable(r)]
        if bad:
            raise ValueError(
                "unservable request(s) "
                f"{[r.request_id for r in bad]}: need 1 <= "
                "max_new_tokens and prompt_len + max_new_tokens + 1 "
                f"<= max_seq (max_seq={self.max_seq})")
        while self.queue:
            sched.submit(self.queue.popleft())
        self.completions.extend(sched.run())
        return self.completions
