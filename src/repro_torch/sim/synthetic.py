"""Synthetic routing-trace generators: policy studies without a model
(port of ``repro.sim.synthetic``, numpy only; the same spec and seed give
the reference's trace).

Each generator emits a fully-formed :class:`~repro_torch.sim.trace.Trace`
(meta + prefill/decode events) that the replay simulator and autotuner
consume exactly like a recorded one.  All streams are deterministic in
their ``seed``; the tenant-mix generator reuses the serving subsystem's
:mod:`repro_torch.serving.workloads` arrival/length/tenant distributions so
offline studies see the same traffic shapes the live scheduler does.

Generators (the scenario axes the paper's policy questions live on):

* :func:`zipf_trace` — stationary Zipf expert hotness, independently
  permuted per layer (the steady-workload baseline; cache-capacity and
  warmup sweeps).
* :func:`phase_shift_trace` — the hotness permutation is redrawn every
  phase (workload drift; stresses hotness aging and PCW reshaping).
* :func:`tenant_mix_trace` — per-tenant hotness rotations driven by a
  :class:`~repro_torch.serving.workloads.WorkloadConfig` tenant mix (shared
  -cache contention between workload classes).
* :func:`transition_trace` — layer-to-layer expert choices follow a
  seeded Markov transition matrix (gives the layer-transition prefetcher
  learnable structure; its counterpoint is the near-random routing of
  ``zipf_trace``, where prefetch mostly wastes).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional

import numpy as np

from repro_torch.sim.trace import DecodeEvent, PrefillEvent, Trace, TraceMeta

__all__ = ["SyntheticSpec", "zipf_trace", "phase_shift_trace",
           "tenant_mix_trace", "tenant_phase_trace", "transition_trace"]


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """Synthetic model topology + cost constants for trace metadata.

    Shapes follow the repo's SwiGLU expert convention (``wi`` maps
    ``d_model -> 2*d_ff``, ``wo`` maps ``d_ff -> d_model``), so slice
    bytes and MAC counts behave like a real (small) MoE.
    """

    n_moe_layers: int = 4
    n_experts: int = 16
    top_k: int = 2
    d_model: int = 64
    d_ff: int = 128
    group_size: int = 32
    high_bits: int = 8
    low_bits: int = 4
    theta: float = 0.5
    cache_frac: float = 0.3      # default cache budget / total store bytes
    system: str = "mobile_soc"

    @property
    def wi_shape(self):
        return (self.d_model, 2 * self.d_ff)

    @property
    def wo_shape(self):
        return (self.d_ff, self.d_model)

    def store_bytes(self) -> float:
        from repro_torch.core.amat import MatConfig, slice_nbytes

        mat = MatConfig(self.high_bits, self.low_bits, self.group_size)
        per_expert = sum(
            slice_nbytes(s, mat.high_bits, mat.group_size,
                         which=w, shift=mat.shift)
            for s in (self.wi_shape, self.wo_shape)
            for w in ("msb", "lsb"))
        return per_expert * self.n_moe_layers * self.n_experts

    def meta(self, **engine_overrides) -> TraceMeta:
        engine = {
            "high_bits": self.high_bits, "low_bits": self.low_bits,
            "cache_bytes": self.cache_frac * self.store_bytes(),
            "policy_kind": "cache_prior", "slice_mode": "dbsc",
            "theta": self.theta, "fetch_lsb_on_miss": True,
            "miss_rate_target": None, "warmup": "pcw",
            "lsb_keep_frac": 0.125, "system": self.system,
            "fused_slices": False, "prefetch_top_m": None,
            "async_io": False, "hotness_request_decay": 0.5,
            "ep_shards": 1, "prefetch_min_obs": 0,
            "prefetch_kind": "request", "prefetch_lookahead": 2,
            "prefetch_min_score": 0.02, "controller": None,
            "placement": "round_robin", "placement_period": 64,
            "replicate_k": 0,
        }
        unknown = set(engine_overrides) - set(engine)
        if unknown:
            raise KeyError(f"unknown engine override(s) {sorted(unknown)}")
        engine.update(engine_overrides)
        return TraceMeta(
            model=f"synthetic_L{self.n_moe_layers}_E{self.n_experts}",
            d_model=self.d_model,
            n_periods=self.n_moe_layers,      # one moe position per period
            moe_positions=(0,),
            n_moe_layers=self.n_moe_layers,
            n_experts=self.n_experts,
            top_k=self.top_k,
            group_size=self.group_size,
            wi_shape=self.wi_shape,
            wo_shape=self.wo_shape,
            resident_bytes=float(12 * self.d_model * self.d_model),
            expert_macs_per_token=(self.d_model * 2 * self.d_ff
                                   + self.d_ff * self.d_model),
            engine=engine,
        )


# --------------------------------------------------------------------------
# draw helpers
# --------------------------------------------------------------------------
def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return p / p.sum()


def _layer_probs(rng: np.random.Generator, spec: SyntheticSpec,
                 a: float) -> np.ndarray:
    """[L, E] per-layer hotness: one Zipf, independently permuted."""
    base = _zipf_probs(spec.n_experts, a)
    out = np.empty((spec.n_moe_layers, spec.n_experts))
    for l in range(spec.n_moe_layers):
        out[l] = base[np.argsort(rng.permutation(spec.n_experts))]
    return out


def _draw_block(rng: np.random.Generator, spec: SyntheticSpec,
                probs: np.ndarray, n_tokens: int):
    """Draw routing arrays ``[L, 1, T, k]`` for ``n_tokens`` tokens.

    Per token: ``k`` distinct experts from the layer's hotness
    distribution; gates are a sorted Dirichlet draw (dominant-head shaped
    like real routers), criticality is the DBSC single-head test.
    """
    L, E, k = spec.n_moe_layers, spec.n_experts, spec.top_k
    ids = np.empty((L, 1, n_tokens, k), np.int32)
    gates = np.empty((L, 1, n_tokens, k), np.float64)
    for l in range(L):
        for t in range(n_tokens):
            ids[l, 0, t] = rng.choice(E, size=k, replace=False,
                                      p=probs[l])
            g = np.sort(rng.dirichlet(np.ones(k)))[::-1]
            gates[l, 0, t] = g
    active = np.ones_like(ids, bool)
    critical = gates >= spec.theta
    return ids, gates, active, critical


def _append_request(events: List, rng: np.random.Generator,
                    spec: SyntheticSpec, probs: np.ndarray, *,
                    prompt_len: int, decode_steps: int,
                    label: Optional[str], request_id: Optional[int],
                    tenant: str = "default") -> None:
    ids, gates, _a, _c = _draw_block(rng, spec, probs, prompt_len)
    events.append(PrefillEvent(ids=ids, gates=gates, label=label,
                               inflight=0, request_id=request_id,
                               tenant=tenant))
    for _ in range(decode_steps):
        ids, gates, active, critical = _draw_block(rng, spec, probs, 1)
        events.append(DecodeEvent(
            ids=ids, gates=gates, active=active, critical=critical,
            slot_mask=np.ones(1, bool), slot_tenants=[tenant]))


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------
def zipf_trace(spec: SyntheticSpec = SyntheticSpec(), *,
               n_requests: int = 4, prompt_len: int = 16,
               decode_steps: int = 32, zipf_a: float = 1.2,
               seed: int = 0, engine_overrides: Optional[dict] = None
               ) -> Trace:
    """Stationary Zipf-hot expert stream (per-layer permutations)."""
    rng = np.random.default_rng(seed)
    probs = _layer_probs(rng, spec, zipf_a)
    events: List = []
    for r in range(n_requests):
        _append_request(events, rng, spec, probs,
                        prompt_len=prompt_len, decode_steps=decode_steps,
                        label=f"req{r}", request_id=r)
    return Trace(meta=spec.meta(**(engine_overrides or {})),
                 events=events)


def phase_shift_trace(spec: SyntheticSpec = SyntheticSpec(), *,
                      phases: int = 3, requests_per_phase: int = 2,
                      prompt_len: int = 16, decode_steps: int = 32,
                      zipf_a: float = 1.2, seed: int = 0,
                      engine_overrides: Optional[dict] = None) -> Trace:
    """Hotness permutation redrawn each phase (workload drift)."""
    rng = np.random.default_rng(seed)
    events: List = []
    rid = 0
    for ph in range(phases):
        probs = _layer_probs(rng, spec, zipf_a)
        for _ in range(requests_per_phase):
            _append_request(
                events, rng, spec, probs, prompt_len=prompt_len,
                decode_steps=decode_steps,
                label=f"ph{ph}/req{rid}", request_id=rid)
            rid += 1
    return Trace(meta=spec.meta(**(engine_overrides or {})),
                 events=events)


def tenant_mix_trace(spec: SyntheticSpec = SyntheticSpec(), *,
                     workload=None, zipf_a: float = 1.2,
                     vocab_size: int = 1024,
                     engine_overrides: Optional[dict] = None) -> Trace:
    """Tenant-rotated hotness driven by a serving WorkloadConfig.

    Request order/lengths/tenants come from
    :func:`repro_torch.serving.workloads.generate` (same seeded streams the
    live scheduler serves); each tenant's expert hotness is the layer
    permutation rotated by a stable per-tenant offset, so tenants
    contend for different expert neighborhoods in the shared cache.
    """
    from repro_torch.serving.workloads import WorkloadConfig, generate

    wl = workload or WorkloadConfig()
    rng = np.random.default_rng(wl.seed)
    base = _layer_probs(rng, spec, zipf_a)
    events: List = []
    for req in generate(wl, vocab_size):
        offset = zlib.crc32(req.tenant.encode()) % spec.n_experts
        probs = np.roll(base, offset, axis=1)
        _append_request(
            events, rng, spec, probs, prompt_len=len(req.prompt),
            decode_steps=req.max_new_tokens,
            label=f"req{req.request_id}", request_id=req.request_id,
            tenant=req.tenant)
    return Trace(meta=spec.meta(**(engine_overrides or {})),
                 events=events)


def tenant_phase_trace(spec: SyntheticSpec = SyntheticSpec(), *,
                       tenants=None,
                       phases: int = 3, requests_per_phase: int = 4,
                       prompt_len: int = 16, decode_steps: int = 32,
                       zipf_a: float = 1.2, seed: int = 0,
                       engine_overrides: Optional[dict] = None) -> Trace:
    """Phase-shifting multi-tenant stream — the SLO-controller soak.

    Combines :func:`phase_shift_trace` (base hotness redrawn every
    phase) with weighted tenant attribution: each request's tenant is
    drawn from ``tenants`` and its hotness is the phase base rotated by
    the tenant's stable crc32 offset — so tenants contend for different
    expert neighborhoods *and* every phase boundary invalidates all of
    them at once.  ``tenants`` is either one name -> weight dict
    (default ``{"premium": 1.0, "batch": 2.0}``) or a sequence of
    ``phases`` such dicts, shifting the *mix itself* at each boundary —
    the traffic shape no static config can be right for on both sides.
    Decode events carry ``slot_tenants``, so the controller (live or
    replayed) sees per-tenant signals.  Labels are ``ph{phase}/req{rid}``.
    """
    if tenants is None:
        tenants = {"premium": 1.0, "batch": 2.0}
    if isinstance(tenants, dict):
        per_phase = [dict(tenants)] * phases
    else:
        per_phase = [dict(mix) for mix in tenants]
        if len(per_phase) != phases:
            raise ValueError(
                f"got {len(per_phase)} tenant mixes for {phases} phases")
    rng = np.random.default_rng(seed)
    events: List = []
    rid = 0
    for ph in range(phases):
        mix = per_phase[ph]
        names = sorted(mix)
        weights = np.array([mix[t] for t in names], np.float64)
        weights = weights / weights.sum()
        base = _layer_probs(rng, spec, zipf_a)
        for _ in range(requests_per_phase):
            tenant = names[int(rng.choice(len(names), p=weights))]
            offset = zlib.crc32(tenant.encode()) % spec.n_experts
            probs = np.roll(base, offset, axis=1)
            _append_request(
                events, rng, spec, probs, prompt_len=prompt_len,
                decode_steps=decode_steps,
                label=f"ph{ph}/req{rid}", request_id=rid, tenant=tenant)
            rid += 1
    return Trace(meta=spec.meta(**(engine_overrides or {})),
                 events=events)


def transition_trace(spec: SyntheticSpec = SyntheticSpec(), *,
                     n_requests: int = 4, prompt_len: int = 16,
                     decode_steps: int = 32, hot_targets: int = 3,
                     concentration: float = 0.85, zipf_a: float = 1.2,
                     seed: int = 0,
                     engine_overrides: Optional[dict] = None) -> Trace:
    """Markov layer-transition routing (prefetcher-learnable).

    Each expert at layer ``l`` sends ``concentration`` of its mass to
    ``hot_targets`` fixed successors at layer ``l+1`` (seeded), the rest
    uniform — the structured-routing regime where layer-transition
    prefetching *can* work, unlike the stochastic Zipf stream.
    """
    rng = np.random.default_rng(seed)
    L, E, k = spec.n_moe_layers, spec.n_experts, spec.top_k
    first_probs = _zipf_probs(E, zipf_a)[
        np.argsort(rng.permutation(E))]
    # trans[l, i]: distribution over layer-(l+1) experts given expert i
    trans = np.full((max(L - 1, 1), E, E),
                    (1.0 - concentration) / E)
    for l in range(max(L - 1, 1)):
        for i in range(E):
            targets = rng.choice(E, size=hot_targets, replace=False)
            trans[l, i, targets] += concentration / hot_targets
        trans[l] /= trans[l].sum(axis=1, keepdims=True)

    def draw_chain(n_tokens: int):
        ids = np.empty((L, 1, n_tokens, k), np.int32)
        gates = np.empty((L, 1, n_tokens, k), np.float64)
        for t in range(n_tokens):
            prev = rng.choice(E, size=k, replace=False, p=first_probs)
            for l in range(L):
                if l > 0:
                    p = trans[l - 1][prev].mean(axis=0)
                    p = p / p.sum()
                    prev = rng.choice(E, size=k, replace=False, p=p)
                ids[l, 0, t] = prev
                g = np.sort(rng.dirichlet(np.ones(k)))[::-1]
                gates[l, 0, t] = g
        active = np.ones_like(ids, bool)
        critical = gates >= spec.theta
        return ids, gates, active, critical

    events: List = []
    for r in range(n_requests):
        ids, gates, _a, _c = draw_chain(prompt_len)
        events.append(PrefillEvent(ids=ids, gates=gates, label=f"req{r}",
                                   inflight=0, request_id=r))
        for _ in range(decode_steps):
            ids, gates, active, critical = draw_chain(1)
            events.append(DecodeEvent(
                ids=ids, gates=gates, active=active, critical=critical,
                slot_mask=np.ones(1, bool)))
    return Trace(meta=spec.meta(**(engine_overrides or {})),
                 events=events)
