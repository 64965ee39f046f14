"""Single-batch serving API (port of ``repro.serving.server``).

:class:`SliceMoEServer` keeps the submit/run interface as a thin wrapper
over the continuous-batching scheduler run with ``max_batch=1``: requests
drain FIFO, one at a time, through a *persistent* engine, so the slice
cache and hotness statistics stay warm across requests.  Trace recording
(:meth:`SliceMoEServer.attach_recorder`), timeline tracing
(:meth:`~SliceMoEServer.attach_tracer`, :meth:`~SliceMoEServer.export_trace`)
and metrics sampling (:meth:`~SliceMoEServer.attach_metrics`) wire into
that engine and the scheduler of each run (persistent MoE serving only).

Pass ``persistent=False`` for the fresh-engine-per-request behavior (the
cold baseline the serving benchmark measures against): each request gets
its own :class:`SliceMoEEngine`, released before the next one is built.
With ``engine_cfg=None`` (or a model without MoE layers) a
:class:`PlainEngine` runs the same prefill/decode without the expert
cache simulation.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import (EngineConfig, PersistentEngine,
                                     SliceMoEEngine, _to_device)
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.serving.scheduler import (Completion, ContinuousBatchingScheduler,
                                           Request, SchedulerConfig)

__all__ = ["Request", "Completion", "PlainEngine", "SliceMoEServer"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PlainEngine:
    """Prefill+decode without offload simulation, eager on ``device``
    (``cuda`` unless told otherwise); parameters are moved there if they
    are elsewhere."""

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int, *,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_seq = max_seq

    def generate(self, prompt: np.ndarray, n_steps: int,
                 eos: Optional[int] = None, **kw):
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=self.device)[None]
        logits, cache, _ = MDL.prefill(self.params, self.cfg, tokens,
                                       self.max_seq, **kw)
        token = torch.argmax(logits, dim=-1)
        out = []
        for _ in range(n_steps):
            out.append(int(token[0]))
            if eos is not None and out[-1] == eos:
                break
            logits, cache, _ = MDL.decode_step(self.params, self.cfg, token,
                                               cache)
            token = torch.argmax(logits, dim=-1)
        return np.asarray(out, np.int32), None


class SliceMoEServer:
    """Runs on ``device`` (``cuda`` unless told otherwise)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 engine_cfg: Optional[EngineConfig] = None,
                 max_seq: int = 256, *, persistent: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.engine_cfg = engine_cfg
        self.persistent = persistent
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

    def _require_persistent_moe(self, what: str) -> None:
        if not (self._moe_serving() and self.persistent):
            raise ValueError(f"{what} requires persistent MoE serving "
                             "(has_moe + engine_cfg + persistent=True)")

    def attach_tracer(self, tracer):
        """Capture the engine's charge-path timeline (persistent MoE
        serving only, like :meth:`attach_recorder`).  The tracer wires
        into the shared engine as soon as it exists; export with
        :meth:`export_trace` after :meth:`run`."""
        self._require_persistent_moe("timeline tracing")
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
        """Sample the metrics registry per decode step (persistent MoE
        serving only); the sampler wires into the scheduler each
        :meth:`run` builds."""
        self._require_persistent_moe("metrics sampling")
        self._metrics = registry
        return registry

    def attach_recorder(self, recorder):
        """Record the served traffic's routing trace (persistent MoE
        serving only: a fresh-engine-per-request run has no single engine
        whose state a trace could replay against).  The recorder wires
        into the shared engine as soon as it exists."""
        self._require_persistent_moe("trace recording")
        self._recorder = recorder
        if self._engine is not None:
            recorder.attach(self._engine)
        return recorder

    def _moe_serving(self) -> bool:
        return self.cfg.has_moe and self.engine_cfg is not None

    def _fresh_engine(self):
        if self._moe_serving():
            ecfg = dataclasses.replace(self.engine_cfg, max_seq=self.max_seq)
            return SliceMoEEngine(self.cfg, self.params, ecfg,
                                  device=self.device)
        return PlainEngine(self.cfg, self.params, self.max_seq,
                           device=self.device)

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
        if not (self._moe_serving() and self.persistent):
            return self._run_cold()
        sched = ContinuousBatchingScheduler(
            self._shared_engine(),
            SchedulerConfig(max_batch=1, max_queue=len(self.queue) + 1),
            device=self.device)
        if self._metrics is not None:
            sched.attach_metrics(self._metrics)
        self.last_scheduler = sched
        # Validate the whole queue before draining any of it: raising
        # mid-drain would strand already-dequeued requests.
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

    def _run_cold(self) -> List[Completion]:
        """A fresh engine per request (the cold baseline), or a plain
        engine for ``engine_cfg=None`` or a model without MoE layers."""
        while self.queue:
            req = self.queue.popleft()
            if self.completions:
                # The last request's engine is unreachable but may sit in
                # reference cycles: collect it before building the next,
                # so that two engines never hold the device at once.
                gc.collect()
            self.completions.append(self._serve_cold(req))
        return self.completions

    def _serve_cold(self, req: Request) -> Completion:
        engine = self._fresh_engine()
        t0 = time.perf_counter()
        if isinstance(engine, SliceMoEEngine):
            logits = engine.prefill(np.asarray(req.prompt)[None])
            _sync(self.device)
            t1 = time.perf_counter()
            first = torch.argmax(logits, dim=-1)
            toks, metrics = engine.decode(first, req.max_new_tokens)
            toks = toks[0].cpu().numpy().astype(np.int32)
            if req.eos_token is not None:
                stop = np.nonzero(toks == req.eos_token)[0]
                if stop.size:
                    toks = toks[:stop[0] + 1]
            t2 = time.perf_counter()
        else:
            t1 = time.perf_counter()
            toks, metrics = engine.generate(
                req.prompt, req.max_new_tokens, eos=req.eos_token)
            _sync(self.device)      # generate() leaves its last step queued
            t2 = time.perf_counter()
        return Completion(request_id=req.request_id, tokens=toks,
                          prefill_s=t1 - t0, decode_s=t2 - t1,
                          metrics=metrics)
