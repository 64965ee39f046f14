"""The system under test: the port's engine and scheduler, driven by a
closed loop, with the probes the benchmark reads.

Everything that touches ``repro_torch`` is here.  The window drives
``ContinuousBatchingScheduler.step()`` over a ``PersistentEngine``; the
benchmark sees the program through its public surface only:

* a routing recorder (``sched.attach_recorder``), which keeps each
  forward's routing arrays;
* thin wrappers around the engine's ``run_prefill`` and ``decode_batch``
  that note what went in (the Cache-Prior boost, the slot mask, the
  residency the step routes by, the tokens fed) and what came out (the
  step's charge counters and modeled energy, whether every logit is
  finite), leaving the calls themselves untouched;
* the scheduler's own host walls per prefill and per decode step.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.lib import loader
from portbench.lib.traffic import Mix, Stream


def slice_bytes(cfg: dict, engine_cfg: dict):
    """(MSB, LSB) slice bytes of one expert in the paper's cost model: per
    matrix, the MSB slice holds the low-bit codes plus an f16 scale and a
    low-bit zero-point per group, the LSB slice the remaining code bits."""
    mat = engine_cfg["mat"]
    hi, lo, g = mat["high_bits"], mat["low_bits"], mat["group_size"]
    moe = cfg["moe"]
    d, f = cfg["d_model"], moe["d_ff"]
    n_wi = 2 * f if moe["mlp_type"] in ("swiglu", "geglu") else f
    sizes = (d * n_wi, f * d)
    return (sum(n * lo / 8 + n / g * (2 + lo / 8) for n in sizes),
            sum(n * (hi - lo) / 8 for n in sizes))


def store_bytes(cfg: dict, engine_cfg: dict, model=None) -> float:
    """The slice store's size: both slices of every expert of every MoE
    layer (the layers of the model module's ``moe_layout``; ``model`` is
    found by its name in ``cfg`` when not given)."""
    model = model or loader.model_module(cfg)
    n_moe = math.prod(model.moe_layout(cfg))
    return sum(slice_bytes(cfg, engine_cfg)) * n_moe \
        * cfg["moe"]["n_experts"]


def engine_config(cfg: dict, engine_cfg: dict, max_seq: int, model):
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    return EngineConfig(
        mat=MatConfig(**engine_cfg["mat"]),
        cache_bytes=store_bytes(cfg, engine_cfg, model)
        * engine_cfg["cache_fraction"],
        policy=RoutingPolicy(**engine_cfg["policy"]),
        miss_rate_target=engine_cfg["miss_rate_target"],
        warmup=engine_cfg["warmup"], system=engine_cfg["system"],
        max_seq=max_seq)


# ------------------------------------------------------------------ probes
@dataclasses.dataclass
class PrefillRec:
    n_tokens: int
    ids: np.ndarray                  # [P, n_moe, S, k]
    active: np.ndarray
    t0: torch.Tensor                 # device: the token the prefill chose
    finite: torch.Tensor             # device bool
    request_id: int = -1
    step: int = -1                   # the decode step this admission preceded


@dataclasses.dataclass
class DecodeRec:
    alpha: float
    cached: np.ndarray               # [n_moe_layers, E] bool, MSB slices
    n_lsb: int                       # LSB slices resident
    slots: Dict[int, tuple]          # slot -> (request id, KV rows after)
    token: torch.Tensor              # device [B]: the tokens fed
    ids: Optional[np.ndarray] = None
    active: Optional[np.ndarray] = None
    critical: Optional[np.ndarray] = None
    slot_mask: Optional[np.ndarray] = None
    finite: Optional[torch.Tensor] = None  # device [B]
    accesses: int = 0
    misses: int = 0
    energy_j: float = 0.0
    per_slot_miss: Optional[np.ndarray] = None


class Probe:
    """The routing recorder and the engine wrappers, in one object."""

    def __init__(self, engine, sched):
        self.engine, self.sched = engine, sched
        self.prefills: List[PrefillRec] = []
        self.decodes: List[DecodeRec] = []
        self._routing = None
        self._run_prefill = engine.run_prefill
        self._decode_batch = engine.decode_batch
        engine.run_prefill = self.run_prefill
        engine.decode_batch = self.decode_batch
        sched.attach_recorder(self)

    # -- recorder interface (``TraceRecorder``'s callbacks)
    def attach(self, engine):
        engine.recorder = self
        return self

    def on_prefill(self, ids, gates, *, active=None, label=None,
                   inflight=0, tenant="default"):
        self._routing = (np.asarray(ids, np.int16),
                         np.ones(ids.shape, bool) if active is None
                         else np.asarray(active, bool))

    def annotate_prefill(self, *, request_id=None, tenant=None):
        self.prefills[-1].request_id = int(request_id)

    def on_decode(self, tr):
        rec = self.decodes[-1]
        rec.ids = np.asarray(tr.ids, np.int16)
        rec.active = np.asarray(tr.active, bool)
        rec.critical = np.asarray(tr.critical, bool)
        rec.slot_mask = np.asarray(tr.slot_mask, bool)

    # -- engine wrappers
    def run_prefill(self, tokens, **kw):
        logits, kv, info = self._run_prefill(tokens, **kw)
        ids, active = self._routing
        self.prefills.append(PrefillRec(
            n_tokens=int(np.asarray(tokens).shape[-1]), ids=ids,
            active=active, t0=torch.argmax(logits, dim=-1)[0],
            finite=torch.isfinite(logits).all(),
            step=len(self.decodes)))
        return logits, kv, info

    def decode_batch(self, token, kv_cache, *, alpha=0.0, slot_active=None,
                     slot_tenants=None, **kw):
        eng = self.engine
        cached, lsb = eng.cache.residency(eng.n_moe_layers, eng.n_experts)
        slots = {s.slot: (s.request.request_id,
                          len(s.request.prompt) + len(s.generated) + 1)
                 for s in self.sched.slots if s is not None}
        rec = DecodeRec(alpha=float(np.float32(alpha)), cached=cached,
                        n_lsb=int(lsb.sum()), slots=slots, token=token)
        self.decodes.append(rec)
        logits, kv_cache, charge = self._decode_batch(
            token, kv_cache, alpha=alpha, slot_active=slot_active,
            slot_tenants=slot_tenants, **kw)
        rec.finite = torch.isfinite(logits).all(dim=-1)
        rec.accesses, rec.misses = int(charge.accesses), int(charge.misses)
        rec.energy_j = float(charge.ledger_delta["total_energy_j"])
        rec.per_slot_miss = np.asarray(charge.per_slot_miss, np.float64)
        return logits, kv_cache, charge


# ------------------------------------------------------------------ serving
class ClosedLoop:
    """``clients`` clients, each sending its next request of the stream
    when its last one completes; one ``step()`` at a time."""

    def __init__(self, mix: Mix, stream: Stream, sched):
        self.mix, self.stream, self.sched = mix, stream, sched
        self.next_index = 0
        self.prompts: Dict[int, np.ndarray] = {}
        self.max_new: Dict[int, int] = {}
        self.step_end: List[float] = []     # host time after each decode
        self.finished: Dict[int, tuple] = {}  # id -> (decode step, tokens)
        self._seen = 0
        for _ in range(mix.clients):
            self._send()

    def _send(self):
        from repro_torch.serving.scheduler import Request

        i = self.next_index
        self.next_index += 1
        prompt, n_new = self.stream.request(i)
        self.prompts[i], self.max_new[i] = prompt, n_new
        if not self.sched.submit(Request(request_id=i, prompt=prompt,
                                         max_new_tokens=n_new)):
            raise RuntimeError(f"the scheduler refused request {i}")

    def step(self) -> float:
        n_dec = len(self.sched.wall_step_s)
        self.sched.step()
        t = time.perf_counter()
        if len(self.sched.wall_step_s) != n_dec + 1:
            raise RuntimeError("a scheduler step ran no decode step")
        self.step_end.append(t)
        done = self.sched.completions
        for c in done[self._seen:]:
            self.finished[c.request_id] = (len(self.step_end) - 1, c.tokens)
            self._send()
        self._seen = len(done)
        return t


def build(cfg: dict, engine_cfg: dict, mix: Mix, seed: int, device, model):
    """Weights from the seed, the engine (AMAT quantization included), the
    scheduler, the probe and the closed loop with its first wave sent.
    ``model``: the configuration's model module."""
    from repro_torch.core.engine import PersistentEngine
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)

    mcfg = model.program_config(cfg)
    t0 = time.perf_counter()
    params = model.make_weights(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    engine = PersistentEngine(mcfg, params, engine_config(
        cfg, engine_cfg, mix.max_seq, model), device=device)
    del params
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"setup: weights {t1 - t0:.3f} s, engine (AMAT quantization) "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=mix.max_batch,
                                max_queue=mix.clients), device=device)
    probe = Probe(engine, sched)
    loop = ClosedLoop(mix, Stream(mix, seed, cfg["vocab_size"]), sched)
    return engine, sched, probe, loop
