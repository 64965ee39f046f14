"""SliceMoE inference engine (port of ``repro.core.engine``).

Runs the PyTorch MoE model token by token while simulating the DRAM/Flash
offload hierarchy.  Per decode step:

  1. ``decode_step`` runs with the current cache residency masks, the
     static :class:`RoutingPolicy` and the Cache-Prior boost ``alpha``; it
     returns next-token logits plus per-layer routing traces;
  2. the routing trace comes to the host in one transfer and the
     :class:`SliceCache` replays the slice demand (MSB always, LSB per
     DBSC criticality), charging the :class:`CostLedger`;
  3. the :class:`MissRateController` updates ``alpha`` from the rolling
     miss rate.

Prefill runs once per request, collecting the hotness PCW needs; the
prefill→decode transition applies the configured warmup.

State splits into :class:`PersistentEngine` (shared across requests:
quantized store, slice cache, hotness tracker, ledger) and per-request
state (KV cache, controller ``alpha``); :class:`SliceMoEEngine` is the
single-request API.

The charge path runs in both disciplines: serialized (``async_io=False``)
and the event-timeline pipeline (``async_io=True``), each with the
configured expert prefetcher (``prefetch_top_m``,
:mod:`repro_torch.core.prefetch`).  Expert parallelism (``ep_shards > 1``)
is simulated in the charge path on the one device the model runs on: a
:class:`ShardedSliceCache` and :class:`ShardedCostLedger` split the DRAM
budget and the channel clocks by shard, the expert placement policy
(:mod:`repro_torch.core.placement`) decides ownership and migrates slices
every ``placement_period`` decode steps, and remote selections pay
all-to-all bytes on the interconnect.  An SLO ``controller``
(:mod:`repro_torch.control`) plans per-tenant bit levels and resizes the
tenant segments of a partitioned cache from charge-path counters only.
The charge path consumes only routing arrays, so
:class:`repro_torch.sim.replay.ReplayEngine` drives the same methods from
a recorded or synthetic trace (``recorder`` captures one from a live run)
and reproduces every placement and controller decision.  The
``tpu_offload`` profile raises ``NotImplementedError`` naming its
ROADMAP.md item.  BuddyMoE routing (``policy.kind="buddy"``) calibrates
its expert pairs from the dense weights when the engine is built.

``run_prefill`` and ``decode_batch`` mark their model forward and their
charge path as ``torch.profiler`` ranges (``slicemoe.prefill_forward``,
``slicemoe.prefill_charge``, ``slicemoe.decode_forward``,
``slicemoe.decode_charge``); the charge ranges include the wait for the
device, since moving the routing trace to the host synchronizes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.control.controller import SLOController
from repro_torch.control.partition import TenantPartitionedCache
from repro_torch.core.amat import MatConfig
from repro_torch.core.cache import SliceCache
from repro_torch.core.placement import build_placement_policy
from repro_torch.core.prefetch import RequestPrefetcher, TransitionPrefetcher
from repro_torch.core.routing import MissRateController, compute_buddies
from repro_torch.core.shard import (ShardedSliceCache, expert_placement,
                                    home_shard_of_token,
                                    remote_selection_mask, shard_of_expert)
from repro_torch.core.slices import SliceKey, quantize_moe_params
from repro_torch.core.warmup import HotnessTracker, INIT_STATES, pcw_reshape
from repro_torch.device import resolve_device
from repro_torch.hw.energy import (CostLedger, ShardedCostLedger,
                                   expert_weight_step_bytes)
from repro_torch.hw.specs import SYSTEM_PROFILES
from repro_torch.models import model as MDL
from repro_torch.models.moe import RoutingPolicy


@dataclasses.dataclass
class EngineConfig:
    mat: MatConfig = dataclasses.field(
        default_factory=lambda: MatConfig(8, 4))
    cache_bytes: float = 64e6
    policy: RoutingPolicy = dataclasses.field(default_factory=RoutingPolicy)
    miss_rate_target: Optional[float] = None      # e.g. 0.05
    warmup: str = "pcw"        # 'pcw' | 'empty' | 'last_layer' | 'random'
    lsb_keep_frac: float = 0.125
    system: str = "mobile_soc"
    max_seq: int = 256
    # Whole-expert caching (high-bit baseline): both slices move together.
    fused_slices: bool = False
    # Layer-transition expert prefetching (the paper's §2.1 baseline):
    # pull the top-m predicted next-layer experts into DRAM per layer.
    # None disables.
    prefetch_top_m: Optional[int] = None
    # Asynchronous slice-I/O timeline: replay decode as a per-expert
    # fill -> DRAM-read -> matmul pipeline over the ledger's channel
    # clocks (Flash / DRAM / XPU), with prefetch fills issued behind
    # demand fills on the Flash channel.  False reproduces the
    # serialized (paper Figs. 9-10) accounting exactly.
    async_io: bool = False
    # Cross-request hotness aging at each request boundary.
    hotness_request_decay: float = 0.5
    # Expert-parallel sharding: partition the experts of every MoE layer
    # across this many shards (simulated in the charge path).  Each shard
    # owns its own slice cache segment (cache_bytes / ep_shards, iso
    # aggregate DRAM) and its own Flash/DRAM/XPU channel clocks; token
    # dispatch to remote experts is charged on the interconnect channel.
    # 1 = the single-device model.
    ep_shards: int = 1
    # Prefetch confidence floor: a target layer must have been observed
    # at least this many times before the prefetcher issues fills for it
    # (0 = issue immediately).  Suppresses cold-start blind fills that
    # burn Flash energy.  Applies to both predictor kinds (the
    # transition baseline reads it as its min_transitions).
    prefetch_min_obs: int = 0
    # Which predictor drives prefetch_top_m:
    #   'request'    — request-level activation matrices with cyclic
    #                  multi-layer-ahead targets (MoE-Infinity style;
    #                  the only kind that can land fills in time in the
    #                  I/O-bound decode regime);
    #   'transition' — the single-step Markov baseline (paper §2.1).
    prefetch_kind: str = "request"
    # Request predictor: how many layers ahead plan() may target
    # (cyclic — distances past the end of the step wrap to the next
    # decode step, which is where the real slack is).
    prefetch_lookahead: int = 2
    # Request predictor: activation-share floor below which a candidate
    # is never issued (shares sum to <= 1 across experts).
    prefetch_min_score: float = 0.02
    # Online SLO controller (repro_torch.control.controller.
    # ControllerConfig): per-tenant closed-loop bit-plan / cache-partition
    # / admission adaptation.  None = static policy.
    controller: Optional[object] = None
    # Expert placement policy across EP shards (repro_torch.core.placement):
    #   'round_robin'          — expert % ep, never migrates;
    #   'hotness'              — greedy balanced bin-packing of hotness-
    #                            ranked experts, re-placed every
    #                            placement_period decode steps with
    #                            migration bytes charged on the ici channel;
    #   'hotness+replicate:K'  — hotness plus the K globally hottest
    #                            experts replicated on every shard.
    # Ignored (after validation) when ep_shards == 1.
    placement: str = "round_robin"
    # Decode steps between hotness re-placements (migration cadence).
    placement_period: int = 64
    # Replication count for the hotness policy (scalar alternative to the
    # '+replicate:K' spec suffix; the explicit knob wins).
    replicate_k: int = 0

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for settings of unported parts."""
        if self.system not in SYSTEM_PROFILES:
            raise NotImplementedError(
                f"not ported yet, see ROADMAP.md: system={self.system!r} "
                "(queue 1, 'tpu_offload profile')")

    def cache(self, *, placement=None):
        slice_aware = self.policy.slice_mode == "dbsc" and not self.fused_slices
        if self.controller is not None and self.controller.partition:
            if self.ep_shards > 1:
                raise ValueError(
                    "controller cache partitioning and ep_shards > 1 are "
                    "mutually exclusive: the DRAM budget cannot be split "
                    "along both the tenant and the placement axis")
            return TenantPartitionedCache(
                self.cache_bytes, sorted(self.controller.slos),
                shared_frac=self.controller.shared_frac,
                slice_aware=slice_aware)
        if self.ep_shards > 1:
            return ShardedSliceCache(self.cache_bytes, self.ep_shards,
                                     slice_aware=slice_aware,
                                     placement=placement)
        return SliceCache(self.cache_bytes, slice_aware=slice_aware)

    def ledger(self):
        system = SYSTEM_PROFILES[self.system]
        if self.ep_shards > 1:
            return ShardedCostLedger(system, self.ep_shards)
        return CostLedger(system=system)

    def build_prefetcher(self, n_layers: int, n_experts: int):
        """The configured predictor (or None) — one factory shared by
        the live engine and the trace-replay engine so a sweep toggling
        ``prefetch_kind`` exercises the identical construction."""
        if not self.prefetch_top_m:
            return None
        if self.prefetch_kind == "transition":
            return TransitionPrefetcher(
                n_layers, n_experts, top_m=self.prefetch_top_m,
                min_transitions=self.prefetch_min_obs)
        if self.prefetch_kind == "request":
            return RequestPrefetcher(
                n_layers, n_experts, top_m=self.prefetch_top_m,
                lookahead=self.prefetch_lookahead,
                min_obs=self.prefetch_min_obs,
                min_score=self.prefetch_min_score)
        raise ValueError(
            f"unknown prefetch_kind {self.prefetch_kind!r}; "
            "expected 'request' or 'transition'")

    def build_placement_policy(self, n_layers: int, n_experts: int):
        """The configured placement policy, or None on a single device.
        Shared by the live engine and the trace-replay engine; the spec is
        validated even at ``ep_shards == 1``."""
        pol = build_placement_policy(
            self.placement, n_layers, n_experts, max(self.ep_shards, 1),
            replicate_k=self.replicate_k if self.replicate_k else None)
        return pol if self.ep_shards > 1 else None


@dataclasses.dataclass
class StepCharge:
    """Result of replaying one decode step into the cache + ledger."""

    miss_rate: float                      # fleet expert-level miss rate
    accesses: int
    misses: int
    per_slot_miss: np.ndarray             # [B] selection-weighted miss rate
    ledger_delta: dict                    # cost delta for this step
    # Per-tenant charge-path counters {tenant: {tokens, accesses, misses,
    # critical, critical_low}}: the SLO controller's input signal.  None
    # unless slot tenants were supplied or a controller is attached.
    per_tenant: Optional[dict] = None


def aux_to_host(moe_aux: dict, keys) -> dict:
    """Routing-trace leaves ``keys`` of one step as numpy arrays, moved
    from the device in ONE transfer.

    The reference converts each aux leaf with ``np.asarray`` (one device
    sync per leaf).  Here every leaf is flattened into one f32 buffer
    first: expert ids (< 2^24), bf16/f32 gates and bool masks are all
    exact in f32.  Ids come back as int64, masks as bool, gates as f64
    (the reference's replay dtype).
    """
    leaves = [moe_aux[k] for k in keys]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for k, t in zip(keys, leaves):
        n = t.numel()
        a = host[off:off + n].reshape(tuple(t.shape))
        off += n
        if t.dtype == torch.bool:
            out[k] = a.astype(bool)
        elif t.dtype.is_floating_point:
            out[k] = a.astype(np.float64)
        else:
            out[k] = a.astype(np.int64)
    return out


@dataclasses.dataclass
class _StepTrace:
    """One decode step's routing trace + mutable replay counters."""

    ids: np.ndarray                       # [P, npos, T, k]
    gates: np.ndarray
    active: np.ndarray
    critical: np.ndarray
    slot_mask: np.ndarray                 # [T] bool
    slot_accesses: np.ndarray             # [T] int64 (mutated during replay)
    slot_misses: np.ndarray
    accesses: int = 0
    misses: int = 0
    # [T] tenant names (None entries = unattributed slots): drive the
    # controller's per-tenant signals and the partitioned cache's fills.
    slot_tenants: Optional[list] = None
    # Controller bit plan for this step: [T] int8, 0 = full AMAT plan,
    # 1 = demoted to MSB-only.  Set by the engine after the recorder sees
    # the trace (recomputed on replay, never recorded).
    slot_bit_level: Optional[np.ndarray] = None
    # Accuracy-proxy counters (mutated during replay): per-slot critical
    # selections, and those served at low precision.
    slot_critical: Optional[np.ndarray] = None
    slot_critical_low: Optional[np.ndarray] = None

    @property
    def P(self) -> int:
        return self.ids.shape[0]

    @classmethod
    def from_aux(cls, aux, slot_active: Optional[np.ndarray],
                 slot_tenants: Optional[list] = None) -> "_StepTrace":
        h = aux_to_host(aux["moe"], ("ids", "gates", "active", "critical"))
        T = h["ids"].shape[2]
        slot_mask = np.ones(T, bool) if slot_active is None \
            else np.asarray(slot_active, bool)
        return cls(
            ids=h["ids"], gates=h["gates"], active=h["active"],
            critical=h["critical"], slot_mask=slot_mask,
            slot_accesses=np.zeros(T, np.int64),
            slot_misses=np.zeros(T, np.int64),
            slot_tenants=slot_tenants,
        )


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class PersistentEngine:
    """Shared-state engine: one instance serves many requests.

    ``run_prefill`` produces a fresh KV cache against the *warm* shared
    slice cache; ``decode_batch`` advances a batch of sequences one token.
    Runs on ``device`` (``cuda`` unless told otherwise); parameters are
    moved there if they are elsewhere.
    """

    def __init__(self, cfg: ModelConfig, params: dict, ecfg: EngineConfig,
                 *, device=None):
        if not cfg.has_moe:
            raise ValueError(f"{cfg.name} has no MoE layers; SliceMoE "
                             "expert caching is inapplicable")
        ecfg.check_ported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        params = _to_device(params, self.device)
        self.moe_positions = [i for i, s in enumerate(cfg.block_pattern)
                              if s.ffn == "moe"]
        # BuddyMoE offline calibration (policy.kind == 'buddy'): nearest
        # expert by weight cosine similarity, per (position, period), from
        # the dense weights, before quantization replaces them.
        self.buddies = None
        if ecfg.policy.kind == "buddy":
            self.buddies = {}
            for i in self.moe_positions:
                wi = params["blocks"][f"pos{i}"]["moe"]["experts"]["wi"]
                flat = wi.reshape(wi.shape[0], wi.shape[1], -1)
                self.buddies[f"pos{i}"] = torch.stack(
                    [compute_buddies(flat[p]) for p in range(flat.shape[0])])
        self.qparams, self.store, self.layer_map = quantize_moe_params(
            params, cfg, ecfg.mat,
            quant_execution=ecfg.policy.quant_execution)
        self.n_moe_layers = len(self.layer_map)
        self.n_experts = cfg.moe.n_experts

        # Expert placement across EP shards: the policy decides the
        # [L, E] -> shard ownership table; the cache routes keys by it.
        # None on a single device.
        self.placement_policy = ecfg.build_placement_policy(
            self.n_moe_layers, self.n_experts)
        self.placement = (self.placement_policy.initial()
                          if self.placement_policy is not None else None)
        # Re-packing bookkeeping: the decode-step counter driving the
        # migration cadence, and the executed migrations [{step, moved,
        # bytes}] that a replay must reproduce exactly.
        self._decode_steps = 0
        self.migration_events: List[dict] = []

        self.cache = ecfg.cache(placement=self.placement)
        self.ledger = ecfg.ledger()
        self.tracker = HotnessTracker(self.n_moe_layers, self.n_experts)
        self.requests_served = 0
        # Optional routing-trace recorder (repro_torch.sim.trace.
        # TraceRecorder): when attached, every prefill's and decode
        # step's routing arrays are captured for offline replay.
        self.recorder = None
        # Timeline tracer hook (ROADMAP.md queue 1, 'Observability'):
        # nothing attaches one yet.
        self.tracer = None
        self.prefetcher = ecfg.build_prefetcher(
            self.n_moe_layers, self.n_experts)
        # Prefetches in flight across decode steps: target flat layer ->
        # {SliceKey: (ready_t, nbytes, distance)}.  The request
        # predictor's cyclic targets judge at the *next* execution of
        # the target layer, which may be next step — state must outlive
        # a single charge_step_trace call.
        self._pf_pending: dict = {}
        # Prefill routes with the configured policy only when it is
        # state-free (cumsum); compute stays high-bit either way.
        self._prefill_policy = ecfg.policy \
            if ecfg.policy.kind == "cumsum" else None
        # Online SLO controller: closed-loop bit-plan / cache-partition
        # adaptation (named apart from the per-request MissRateController).
        self.slo_controller = None
        if ecfg.controller is not None:
            self.slo_controller = SLOController(
                ecfg.controller, cache_bytes=ecfg.cache_bytes)

        # Non-expert resident weight bytes touched per decode step (INT8
        # per the paper's G128 non-expert quantization).
        total = MDL.count_params(params)
        expert_total = 0
        for i in self.moe_positions:
            e = params["blocks"][f"pos{i}"]["moe"]["experts"]
            expert_total += sum(int(np.prod(x.shape)) for x in e.values())
        self.resident_bytes = float(total - expert_total)

        m = cfg.moe
        wi_cols = 2 * m.d_ff if m.mlp_type in ("swiglu", "geglu") else m.d_ff
        self.expert_macs_per_token = cfg.d_model * wi_cols + m.d_ff * cfg.d_model

    # ------------------------------------------------------- introspection
    def expert_weight_bytes_per_step(self, *,
                                     quant_execution: Optional[bool] = None
                                     ) -> float:
        """Analytic device-memory expert-weight traffic of one decode step
        (:func:`repro_torch.hw.energy.expert_weight_step_bytes`)."""
        if quant_execution is None:
            quant_execution = self.ecfg.policy.quant_execution
        n_codes = n_groups = 0.0
        for le in self.store.layers.values():
            for q in (le.wi_q, le.wo_q):
                n_codes += float(np.prod(q.codes.shape))
                n_groups += float(np.prod(q.scales.shape))
        return expert_weight_step_bytes(
            n_codes, n_groups, quant_execution=quant_execution,
            dense_itemsize=MDL._dt(self.cfg).itemsize)

    def shard_breakdown(self) -> Optional[List[dict]]:
        """Per-shard serving breakdown (None on a single-device engine):
        lifetime cache accesses/misses, Flash/DRAM traffic, energy and the
        shard's timeline makespan, one row per shard."""
        if not isinstance(self.ledger, ShardedCostLedger) \
                or not isinstance(self.cache, ShardedSliceCache):
            return None
        rows = []
        counts = self.cache.per_shard_counts()
        if self.placement is not None:
            # Ownership can differ per layer under the hotness policy; the
            # row reports the first MoE layer's assignment.
            owner0 = self.placement.owner_row(0)
        else:
            owner0 = expert_placement(self.n_experts, self.ledger.n_shards)
        for sid, led in enumerate(self.ledger.shards):
            acc, miss = counts[sid]
            rows.append({
                "shard": sid,
                "experts": np.nonzero(owner0 == sid)[0].tolist(),
                "accesses": acc,
                "misses": miss,
                "miss_rate": miss / max(acc, 1),
                "flash_bytes": led.flash_bytes,
                "dram_bytes": led.dram_bytes,
                "energy_j": led.total_energy_j,
                "makespan_s": led.now,
            })
        return rows

    def placement_summary(self) -> Optional[dict]:
        """Placement policy + migration accounting (None unsharded)."""
        if self.placement is None:
            return None
        return {
            "policy": self.placement_policy.name,
            "period": int(self.ecfg.placement_period),
            "replicated_pairs": int(np.count_nonzero(
                self.placement.replicated)),
            "n_migration_events": len(self.migration_events),
            "migrated_slices": sum(e["moved"]
                                   for e in self.migration_events),
            "migration_bytes": float(
                getattr(self.ledger, "migration_bytes", 0.0)),
        }

    # --------------------------------------------------- per-request state
    def new_controller(self) -> Optional[MissRateController]:
        """Fresh per-request miss-rate controller (None if unconstrained)."""
        if self.ecfg.miss_rate_target is None:
            return None
        return MissRateController(self.ecfg.miss_rate_target)

    def init_batch_cache(self, max_batch: int) -> dict:
        """Batched KV-cache tree with per-sequence positions."""
        cache = MDL.init_cache(self.cfg, max_batch, self.ecfg.max_seq,
                               device=self.device)
        cache["pos"] = torch.zeros((max_batch,), dtype=torch.int64,
                                   device=self.device)
        return cache

    @staticmethod
    def install_slot(batch_cache: dict, request_cache: dict,
                     slot: int) -> dict:
        """Copy a batch-1 prefill cache into ``slot`` of a batched cache
        (in place; returns ``batch_cache``).  Leaves are
        ``[n_periods, B, ...]``; the prefill cache has B=1."""
        for key, entry in batch_cache.items():
            if key == "pos":
                continue
            for name, leaf in entry.items():
                leaf[:, slot] = request_cache[key][name][:, 0].to(leaf.dtype)
        batch_cache["pos"][slot] = request_cache["pos"]
        return batch_cache

    @staticmethod
    def clear_slot(batch_cache: dict, slot: int) -> dict:
        """Retire ``slot``: reset its position (KV rows become dead)."""
        batch_cache["pos"][slot] = 0
        return batch_cache

    # ------------------------------------------------------------- prefill
    def run_prefill(self, tokens, *, label: Optional[str] = None,
                    inflight: int = 0, tenant: str = "default"):
        """Prefill one request against the warm shared cache.

        Returns ``(logits, kv_cache, info)``.  ``label`` archives the
        request's prefill hit/miss counters as a stats epoch; ``inflight``
        (sequences decoding) scales the hotness boundary decay.
        """
        self._begin_request(label, inflight, tenant=tenant)
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        with record_function("slicemoe.prefill_forward"):
            logits, kv_cache, aux = MDL.prefill(
                self.qparams, self.cfg, tokens, self.ecfg.max_seq,
                collect_trace=True, mat=self.ecfg.mat,
                quant_execution=self.ecfg.policy.quant_execution,
                policy=self._prefill_policy)
        with record_function("slicemoe.prefill_charge"):
            keys = ("ids", "gates") + (("active",) if "active" in aux["moe"]
                                       else ())
            h = aux_to_host(aux["moe"], keys)
            active = h.get("active")
            if active is not None and active.all():
                active = None
            if self.recorder is not None:
                self.recorder.on_prefill(h["ids"], h["gates"], active=active,
                                         label=label, inflight=inflight,
                                         tenant=tenant)
            self._charge_prefill(h["ids"], h["gates"], active)
            info = self._finish_prefill(label)
        return logits, kv_cache, info

    def _begin_request(self, label: Optional[str], inflight: int,
                       tenant: str = "default") -> None:
        """Request-boundary bookkeeping: hotness aging + stats epoch."""
        self.cache.set_active_tenant(tenant)
        if self.requests_served > 0:
            decay = self.ecfg.hotness_request_decay \
                ** (1.0 / (1.0 + max(inflight, 0)))
            self.tracker.begin_request(decay)
            if self.prefetcher is not None:
                # Request-level predictor state ages on the same schedule
                # as cache hotness (no-op on the transition baseline).
                self.prefetcher.begin_request(decay)
        self.requests_served += 1
        if label is not None:
            self.cache.begin_epoch(f"{label}/prefill")

    def _charge_prefill(self, ids: np.ndarray, gates: np.ndarray,
                        active: Optional[np.ndarray] = None) -> None:
        """Replay one prompt's layer-streaming fills + compute charges.

        ``ids``/``gates``/``active``: ``[n_periods, n_moe_pos, T, k]``;
        deactivated selections charge neither fills nor hotness.
        """
        if active is None:
            active = np.ones(ids.shape, bool)
        for period in range(ids.shape[0]):
            for pidx, pos in enumerate(self.moe_positions):
                lidx = self.layer_map[(pos, period)]
                a2d = active[period, pidx]                       # [T, k]
                sel_ids = ids[period, pidx][a2d]
                sel_gates = gates[period, pidx][a2d]
                self.tracker.observe(lidx, sel_ids, sel_gates)
                if self.prefetcher is not None:
                    # Seed the request-level activation matrix from
                    # prompt routing (no-op on the transition baseline).
                    self.prefetcher.observe_prefill(
                        lidx, sel_ids, sel_gates,
                        n_tokens=int(a2d.any(axis=1).sum()))
                # All-to-all: prompt tokens live round-robin across
                # shards; selections landing on remote experts pay
                # dispatch + combine bytes (zero on a single device).
                nb_a2a, _ = self._a2a_layer_demand(lidx, a2d,
                                                   ids[period, pidx])
                if nb_a2a > 0:
                    self.ledger.ici_transfer(nb_a2a)
                rep = self._replica_targets(lidx, a2d, ids[period, pidx])
                for e in np.unique(sel_ids):
                    e = int(e)
                    # A replicated expert streams into every shard whose
                    # tokens selected it (each replica charged against
                    # that shard's cache + channels); everything else
                    # fills the owning shard.
                    if e in rep:
                        segs = [(self.cache.shards[sid],
                                 self.ledger.shards[sid])
                                for sid, _ in rep[e]]
                    else:
                        segs = [(self.cache, self._ledger_for(lidx, e))]
                    for cache_seg, led in segs:
                        for kind in ("msb", "lsb"):   # prefill is high-bit
                            key = SliceKey(lidx, e, kind)
                            nb = self.store.slice_bytes(key)
                            hit = cache_seg.access(key, nb)
                            if hit or key in cache_seg:
                                if not hit:           # fill landed
                                    led.miss_fill(nb)
                                led.dram_read(nb)
                            else:                     # dropped: stream
                                led.flash_stream(nb)
                # Prefill compute: all actively routed tokens at high
                # precision, split over the shards executing the
                # selections (the owner; the token's home shard for a
                # replicated expert).
                exec_sh = None if self._n_shards() == 1 else \
                    self._selection_exec_shards(lidx, a2d, ids[period, pidx])
                for sid, led in enumerate(self._shard_ledgers()):
                    t_s = sel_ids.size if exec_sh is None else \
                        int(np.count_nonzero(exec_sh == sid))
                    led.matmul(t_s, self.cfg.d_model,
                               self.expert_macs_per_token // self.cfg.d_model,
                               self.ecfg.mat.high_bits)

    def _finish_prefill(self, label: Optional[str]) -> dict:
        """Prefill→decode transition: warmup reshape + epoch rollover."""
        if self.ecfg.warmup == "pcw":
            warmup_summary = pcw_reshape(
                self.cache, self.store, self.tracker,
                lsb_keep_frac=self.ecfg.lsb_keep_frac)
        else:
            INIT_STATES[self.ecfg.warmup](self.cache, self.store)
            warmup_summary = {"init": self.ecfg.warmup}
        # Admission-time prefetch: issue from the prompt-seeded activation
        # matrix now that the reshape has settled residency (no-op for
        # the transition baseline and with prefetch off).
        self._prefetch_issue_prefill()
        snapshot = self.ledger.snapshot()
        if label is not None:
            self.cache.begin_epoch(f"{label}/decode")
        else:
            self.cache.stats.reset()
        return {"warmup": warmup_summary, "snapshot": snapshot}

    # -------------------------------------------------------------- decode
    def _policy_state(self) -> dict:
        """Residency masks ``cached_msb``/``cached_lsb`` [n_periods, E] per
        MoE position, moved to the device in one transfer, and with buddy
        routing the calibrated ``buddies`` [n_periods, E]."""
        msb, lsb = self.cache.residency(self.n_moe_layers, self.n_experts)
        n_periods = self.cfg.n_periods
        npos = len(self.moe_positions)
        host = np.zeros((npos, 2, n_periods, self.n_experts), bool)
        for j, pos in enumerate(self.moe_positions):
            for period in range(n_periods):
                lidx = self.layer_map[(pos, period)]
                host[j, 0, period] = msb[lidx]
                host[j, 1, period] = lsb[lidx]
        dev = torch.from_numpy(host).to(self.device)
        state = {f"pos{pos}": {"cached_msb": dev[j, 0],
                               "cached_lsb": dev[j, 1]}
                 for j, pos in enumerate(self.moe_positions)}
        if self.buddies is not None:
            for key, b in self.buddies.items():
                state[key]["buddies"] = b
        return state

    def _decode(self, token: torch.Tensor, kv_cache: dict, alpha: float,
                token_mask: Optional[torch.Tensor]):
        # The reference feeds alpha as an f32 scalar; round it the same way.
        return MDL.decode_step(
            self.qparams, self.cfg, token, kv_cache, collect_trace=True,
            policy=self.ecfg.policy, policy_state=self._policy_state(),
            alpha=float(np.float32(alpha)), mat=self.ecfg.mat,
            token_mask=token_mask,
            quant_execution=self.ecfg.policy.quant_execution)

    def decode_batch(self, token: torch.Tensor, kv_cache: dict, *,
                     alpha: float = 0.0,
                     slot_active: Optional[np.ndarray] = None,
                     slot_tenants: Optional[list] = None):
        """One batched decode step for the scheduler.

        ``token``: [B] (padding slots carry an arbitrary token);
        ``slot_active``: [B] bool — padding slots are masked out of MoE
        routing and of cache/cost accounting.
        Returns ``(logits [B, V], kv_cache, StepCharge)``.
        """
        mask = None if slot_active is None else torch.as_tensor(
            np.asarray(slot_active, bool), device=self.device)
        with record_function("slicemoe.decode_forward"):
            logits, kv_cache, aux = self._decode(token, kv_cache, alpha, mask)
        with record_function("slicemoe.decode_charge"):
            charge = self.charge_decode_step(aux, slot_active=slot_active,
                                             slot_tenants=slot_tenants)
        return logits, kv_cache, charge

    def charge_decode_step(self, aux,
                           slot_active: Optional[np.ndarray] = None,
                           slot_tenants: Optional[list] = None
                           ) -> StepCharge:
        """Replay one decode step's slice demand into cache + ledger."""
        return self.charge_step_trace(
            _StepTrace.from_aux(aux, slot_active, slot_tenants))

    def charge_step_trace(self, tr: _StepTrace) -> StepCharge:
        """Charge an already-assembled :class:`_StepTrace`.

        The model-free entry point shared by the live engine (which
        builds the trace from the forward's routing aux) and the
        trace-replay simulator (which builds it from a recorded or
        synthetic trace): both run the identical cache/ledger replay.

        * ``async_io=False`` — serialized issue: every Flash fill, DRAM
          read and matmul blocks the timeline;
        * ``async_io=True`` — a double-buffered layer pipeline: each
          expert's fill → DRAM read → matmul chain is issued with real
          data dependencies on the per-channel clocks, prefetch fills
          ride the Flash channel behind demand fills, and only the layer
          that consumes a late slice stalls.

        The SLO controller is applied entirely inside this function: it
        plans the step's bit levels after the recorder captures the raw
        trace and observes/actuates after the charge, consuming only
        charge-path counters, so a replay recomputes its decisions.
        """
        if self.recorder is not None:
            self.recorder.on_decode(tr)
        # Placement re-packing runs after the recorder and before any
        # charging; it consumes only charge-path state (the hotness
        # tracker and the decode-step counter), so a replay recomputes
        # the identical migration sequence.
        self._maybe_migrate()
        ctl = self.slo_controller
        T = tr.slot_mask.shape[0]
        if ctl is not None:
            tr.slot_bit_level = ctl.plan_bits(tr.slot_tenants, T)
        # Accuracy-proxy counters run controller or not, so a static
        # config's low-bit exposure is measurable on the same accounting.
        tr.slot_critical = np.zeros(T, np.int64)
        tr.slot_critical_low = np.zeros(T, np.int64)
        replay = self._charge_async if self.ecfg.async_io \
            else self._charge_sync
        charge = replay(tr)
        if ctl is not None:
            actions = ctl.observe_step(charge.per_tenant or {},
                                       charge.ledger_delta)
            budgets = actions.get("budgets")
            if budgets and self._partitioned:
                self.cache.set_budgets(budgets)
        return charge

    # -------------------------------------------------- shard routing bits
    # The helpers dispatch on the ledger and cache objects, not on the
    # config, so a replay can swap sharded components onto an engine
    # (``ReplayEngine.force_sharded``) and exercise the identical path.
    def _shard_ledgers(self) -> List[CostLedger]:
        led = self.ledger
        if isinstance(led, ShardedCostLedger):
            return led.shards
        return [led]

    def _n_shards(self) -> int:
        led = self.ledger
        return led.n_shards if isinstance(led, ShardedCostLedger) else 1

    def _owner_shard(self, lidx: int, expert: int) -> int:
        """Owning shard of ``expert`` at MoE layer ``lidx`` under the
        active placement map (round-robin modulo without one)."""
        if self.placement is not None:
            return self.placement.owner_of(lidx, expert)
        return shard_of_expert(expert, self._n_shards())

    def _ledger_for(self, lidx: int, expert: int) -> CostLedger:
        """The cost ledger owning ``expert``'s slices at ``lidx``."""
        led = self.ledger
        if isinstance(led, ShardedCostLedger):
            return led.shards[self._owner_shard(lidx, int(expert))]
        return led

    def _compute_frontier(self) -> float:
        led = self.ledger
        if isinstance(led, ShardedCostLedger):
            return led.compute_frontier()
        return led.compute_ch.busy_until

    def _segment_capacity(self, key: SliceKey) -> float:
        """Capacity of the cache segment that would hold ``key``: the
        owning shard's share under EP, the targeted tenant segment under
        partitioning, the whole cache otherwise (the "would this fill be
        dropped" bound)."""
        if isinstance(self.cache, ShardedSliceCache):
            return self.cache.shard(key).capacity
        if self._partitioned:
            return self.cache.fill_capacity()
        return self.cache.capacity

    @property
    def _partitioned(self) -> bool:
        """Whether the cache routes fills into per-tenant segments."""
        return isinstance(self.cache, TenantPartitionedCache)

    def _expert_owner(self, tr: _StepTrace, period: int, pidx: int):
        """expert id -> tenant whose segment a miss fill charges: the
        first active slot (in slot order, so replay agrees) selecting that
        expert.  None when fills are unattributed (no tenants, or the
        cache is not partitioned)."""
        if tr.slot_tenants is None or not self._partitioned:
            return None
        owner: dict = {}
        act2d = tr.active[period, pidx] & tr.slot_mask[:, None]
        for b in np.nonzero(tr.slot_mask)[0]:
            t = tr.slot_tenants[b]
            if t is None:
                continue
            for e in tr.ids[period, pidx][b][act2d[b]]:
                owner.setdefault(int(e), t)
        return owner

    def _placement_rows(self, lidx: int):
        """(owner_row, replicated_row) for ``lidx``; (None, None) when no
        placement map is active."""
        if self.placement is None:
            return None, None
        return (self.placement.owner_row(lidx),
                self.placement.replicated_row(lidx))

    def _a2a_layer_demand(self, lidx: int, act2d: np.ndarray,
                          ids2d: np.ndarray):
        """All-to-all demand ``(bytes, remote_experts)`` of one layer's
        ``[T, k]`` routing.  Each active selection whose expert lives on
        another shard than its token moves its activation out and the
        result back; selections of replicated experts are never remote.
        ``(0.0, frozenset())`` on a single device."""
        n = self._n_shards()
        if n == 1:
            return 0.0, frozenset()
        rows, _ = np.nonzero(act2d)
        sel = ids2d[act2d]
        orow, rrow = self._placement_rows(lidx)
        remote = remote_selection_mask(rows, sel, n,
                                       owner_row=orow, replicated_row=rrow)
        if not remote.any():
            return 0.0, frozenset()
        return (2.0 * self.cfg.d_model * float(np.count_nonzero(remote)),
                frozenset(int(e) for e in np.unique(sel[remote])))

    def _layer_a2a_demand(self, tr: _StepTrace, period: int, pidx: int,
                          lidx: int):
        if self._n_shards() == 1:
            return 0.0, frozenset()
        return self._a2a_layer_demand(
            lidx,
            tr.active[period, pidx] & tr.slot_mask[:, None],
            tr.ids[period, pidx])

    def _replica_targets(self, lidx: int, act2d: np.ndarray,
                         ids2d: np.ndarray) -> dict:
        """Replica dispatch plan for one layer: ``{expert: [(shard,
        n_tokens), ...]}`` over the replicated experts with at least one
        active selection, each expert's tokens split by home shard.
        Empty unless a placement map with replication is active."""
        if self.placement is None:
            return {}
        rrow = self.placement.replicated_row(lidx)
        if not rrow.any():
            return {}
        n = self._n_shards()
        rows, _ = np.nonzero(act2d)
        sel = ids2d[act2d]
        mask = rrow[sel]
        out: dict = {}
        for tok, e in zip(rows[mask], sel[mask]):
            d = out.setdefault(int(e), {})
            sid = home_shard_of_token(int(tok), n)
            d[sid] = d.get(sid, 0) + 1
        return {e: sorted(d.items()) for e, d in out.items()}

    def _selection_exec_shards(self, lidx: int, act2d: np.ndarray,
                               ids2d: np.ndarray) -> np.ndarray:
        """Shard executing each active selection's expert matmul: the
        owner, except replicated experts run on the token's home shard."""
        n = self._n_shards()
        rows, _ = np.nonzero(act2d)
        sel = ids2d[act2d]
        if self.placement is None:
            return shard_of_expert(sel, n)
        owner = self.placement.owner_row(lidx)[sel]
        rep = self.placement.replicated_row(lidx)[sel]
        if rep.any():
            owner = np.where(rep, home_shard_of_token(rows, n), owner)
        return owner

    def _maybe_migrate(self) -> None:
        """Periodic hotness re-placement at decode-step granularity.

        Deterministic in charge-path state only (the hotness tracker and
        the step counter), so record -> replay reproduces the identical
        placement maps, moves and interconnect charges.  Each moved
        slice's bytes are charged on the ici channel."""
        pol = self.placement_policy
        if pol is None or not pol.migrates or self._n_shards() <= 1:
            return
        self._decode_steps += 1
        period = max(int(self.ecfg.placement_period), 1)
        if self._decode_steps % period:
            return
        new_map = pol.replace(self.tracker.hotness())
        if new_map == self.placement:
            return
        moves = self.cache.apply_placement(new_map)
        self.placement = new_map
        for _key, nb, _frm, _to in moves:
            self.ledger.migrate(nb)
        self.migration_events.append({
            "step": self._decode_steps,
            "moved": len(moves),
            "bytes": float(sum(m[1] for m in moves)),
        })

    # -------------------------------------------------- shared replay bits
    def _slice_nbytes(self, key: SliceKey) -> float:
        if self.ecfg.fused_slices:
            return self.store.highbit_expert_bytes()
        return self.store.slice_bytes(key)

    def _layer_demand(self, tr: _StepTrace, period: int, pidx: int):
        """Demand for one (period, position) layer over *active* slots."""
        mode = self.ecfg.policy.slice_mode
        act2d = tr.active[period, pidx] & tr.slot_mask[:, None]   # [T, k]
        flat_ids = tr.ids[period, pidx][act2d]
        flat_gates = tr.gates[period, pidx][act2d]
        msb_demand = np.unique(flat_ids)
        crit2d = act2d & tr.critical[period, pidx]
        demoted = None if tr.slot_bit_level is None \
            else tr.slot_bit_level > 0                            # [T]
        if mode == "highbit":
            lsb_wanted = set(int(e) for e in msb_demand)
        elif mode in ("lowbit", "amat_static"):
            lsb_wanted = set()
        else:   # dbsc: a controller-demoted slot stops demanding LSBs;
            # an expert critically selected by any kept slot keeps its LSB
            kept2d = crit2d if demoted is None \
                else crit2d & ~demoted[:, None]
            lsb_wanted = set(int(e) for e in np.unique(
                tr.ids[period, pidx][kept2d]))
        if tr.slot_critical is not None:
            # Accuracy proxy, plan-level: a demoted slot's critical
            # selections all count as served-low.
            tr.slot_critical += crit2d.sum(axis=1)
            if mode in ("lowbit", "amat_static"):
                tr.slot_critical_low += crit2d.sum(axis=1)
            elif mode == "dbsc" and demoted is not None:
                tr.slot_critical_low += \
                    (crit2d & demoted[:, None]).sum(axis=1)
        tok_per_e = np.bincount(flat_ids, minlength=self.n_experts)
        return flat_ids, flat_gates, msb_demand, lsb_wanted, tok_per_e

    def _expert_bits(self, lsb_available: bool) -> int:
        """Matmul bit-width from the slot-masked demand."""
        mat = self.ecfg.mat
        mode = self.ecfg.policy.slice_mode
        if self.ecfg.fused_slices or mode == "highbit":
            return mat.high_bits
        if mode in ("lowbit", "amat_static"):
            return mat.low_bits
        return mat.high_bits if lsb_available else mat.low_bits  # dbsc

    def _msb_resident_row(self, lidx: int) -> np.ndarray:
        """[E] bool: experts whose MSB slice for ``lidx`` is cached."""
        row = np.zeros(self.n_experts, bool)
        for e in range(self.n_experts):
            row[e] = SliceKey(lidx, e, "msb") in self.cache
        return row

    # ------------------------------------------- request-kind prefetch bits
    def _pf_pending_keys(self) -> set:
        keys: set = set()
        for m in self._pf_pending.values():
            keys.update(m)
        return keys

    def _lsb_prefetch_allowed(self, tr: _StepTrace) -> bool:
        """Whether LSB slices are worth prefetching this step: DBSC mode
        only (other modes never demand LSBs separately), and not when the
        controller has demoted every active slot to MSB-only."""
        if self.ecfg.policy.slice_mode != "dbsc" or self.ecfg.fused_slices:
            return False
        demoted = tr.slot_bit_level
        if demoted is not None and tr.slot_mask.any() \
                and bool((demoted[tr.slot_mask] > 0).all()):
            return False
        return True

    def _prefetch_judge(self, lidx: int, msb_demand: np.ndarray,
                        lsb_wanted: set, t_route: float) -> None:
        """Judge pending prefetches targeting ``lidx`` against the
        layer's actual demand, *before* demand charging mutates the
        cache.  Kind-aware: an LSB fill is useful only if the layer
        wanted that expert's LSB.  ``t_route`` is the usefulness bar
        (serialized replay passes 0.0 — fills land instantly there).

        A pending entry survives un-demanded as long as it stays
        resident; it is wasted when evicted unused or still unused when
        the run flushes (:meth:`_prefetch_flush`).  Conservation
        ``issued == useful + late + wasted + in_flight`` holds
        throughout."""
        pf = self.prefetcher
        demanded = set(int(e) for e in msb_demand)
        survivors = {}
        for key, (ready_t, p_nb, d) in \
                self._pf_pending.pop(lidx, {}).items():
            if key not in self.cache:        # evicted before use
                pf.mark_wasted(distance=d)
                self._ledger_for(key.layer,
                                 key.expert).mark_prefetch_wasted(p_nb)
            elif (key.expert in demanded if key.kind == "msb"
                  else key.expert in lsb_wanted):
                if ready_t <= t_route:
                    pf.mark_useful(distance=d)
                else:
                    pf.mark_late(distance=d)
            else:                            # resident, un-demanded: wait
                survivors[key] = (ready_t, p_nb, d)
        if survivors:
            self._pf_pending[lidx] = survivors

    def _prefetch_flush(self) -> None:
        """End-of-run settlement for the request-kind predictor: any
        pending fill still unused is wasted, exactly like an eviction
        before use.  Afterwards ``issued == useful + late + wasted`` and
        ``in_flight`` is zero."""
        pf = self.prefetcher
        if pf is None or pf.kind != "request":
            return
        for m in self._pf_pending.values():
            for key, (ready_t, p_nb, d) in m.items():
                pf.mark_wasted(distance=d)
                self._ledger_for(key.layer,
                                 key.expert).mark_prefetch_wasted(p_nb)
        self._pf_pending.clear()

    def _prefetch_issue(self, lidx: int, flat_ids: np.ndarray,
                        t_issue: float, tr: _StepTrace, *,
                        timeline: bool) -> None:
        """Plan + enqueue request-predictor fills after ``lidx`` routed.

        Fills ride the owning shard's Flash background lane behind the
        layer's demand fills (``timeline=True``) or charge the serialized
        accounting (``timeline=False``).  Capacity-skipped candidates
        never count as issued — they moved no bytes."""
        pf = self.prefetcher
        if self._partitioned:    # speculative fills: shared segment
            self.cache.set_active_tenant(None)
        cands = pf.plan(
            lidx, flat_ids,
            is_resident=lambda k: k in self.cache,
            slice_bytes=self._slice_nbytes,
            pending=self._pf_pending_keys(),
            lsb_allowed=self._lsb_prefetch_allowed(tr))
        for key, d in cands:
            nb = self._slice_nbytes(key)
            if key in self.cache or nb > self._segment_capacity(key):
                continue
            led = self._ledger_for(key.layer, key.expert)
            if timeline:
                # Background-priority lane: speculative fills never
                # delay the demand queue (demand preempts).
                _, end = led.prefetch_fill_at(t_issue, nb)
                self.cache.insert(key, nb)
                self.cache.mark_inflight(key, end)
            else:
                led.prefetch_fill_at(None, nb)
                self.cache.insert(key, nb)
                end = 0.0
            self._pf_pending.setdefault(key.layer, {})[key] = \
                (end, nb, d)
            pf.mark_issued(distance=d)

    def _prefetch_issue_prefill(self) -> None:
        """Admission-time issuance: once per request, after the prefill
        charge seeded the activation matrix and the warmup reshape
        settled residency.  Fills charge the serialized accounting —
        prefill is off the decode timeline in both engine modes — so
        ``ready_t = 0.0`` at the first decode judge of a sync run."""
        pf = self.prefetcher
        if pf is None or pf.kind != "request" or not pf.top_m:
            return
        if self._partitioned:    # speculative fills: shared segment
            self.cache.set_active_tenant(None)
        cands = pf.plan_prefill(
            is_resident=lambda k: k in self.cache,
            slice_bytes=self._slice_nbytes,
            pending=self._pf_pending_keys())
        for key, d in cands:
            nb = self._slice_nbytes(key)
            if key in self.cache or nb > self._segment_capacity(key):
                continue
            _, end = self._ledger_for(key.layer,
                                      key.expert).prefetch_fill_at(None, nb)
            self.cache.insert(key, nb)
            if not self.ecfg.async_io:
                end = 0.0    # serialized judge bar is t_route == 0.0
            self._pf_pending.setdefault(key.layer, {})[key] = \
                (end, nb, d)
            pf.mark_issued(distance=d)

    def _attribute_slot_misses(self, tr: _StepTrace, period: int, pidx: int,
                               missed_expert: np.ndarray,
                               missed_rep: Optional[dict] = None) -> None:
        """Charge each slot for every selection that landed on an expert
        whose slice(s) missed this layer-step.  ``missed_rep`` (``{expert:
        {shards that missed}}``) scopes a replicated expert's miss to the
        slots homed on the shards whose replica missed."""
        n = self._n_shards()
        for b in np.nonzero(tr.slot_mask)[0]:
            sel = tr.ids[period, pidx][b][tr.active[period, pidx][b]]
            tr.slot_accesses[b] += sel.size
            miss = int(missed_expert[sel].sum())
            if missed_rep:
                home = home_shard_of_token(int(b), n)
                miss += sum(1 for e in sel
                            if home in missed_rep.get(int(e), ()))
            tr.slot_misses[b] += miss

    def _per_tenant_counts(self, tr: _StepTrace) -> Optional[dict]:
        """Per-slot replay counters aggregated by tenant (slots with no
        tenant fall under "default")."""
        if tr.slot_tenants is None and self.slo_controller is None:
            return None
        out: dict = {}
        for b in np.nonzero(tr.slot_mask)[0]:
            t = "default"
            if tr.slot_tenants is not None \
                    and tr.slot_tenants[b] is not None:
                t = tr.slot_tenants[b]
            row = out.setdefault(t, {"tokens": 0, "accesses": 0,
                                     "misses": 0, "critical": 0,
                                     "critical_low": 0})
            row["tokens"] += 1
            row["accesses"] += int(tr.slot_accesses[b])
            row["misses"] += int(tr.slot_misses[b])
            if tr.slot_critical is not None:
                row["critical"] += int(tr.slot_critical[b])
                row["critical_low"] += int(tr.slot_critical_low[b])
        return out

    def _step_charge(self, tr: _StepTrace, base: dict) -> StepCharge:
        return StepCharge(
            miss_rate=tr.misses / max(tr.accesses, 1),
            accesses=tr.accesses,
            misses=tr.misses,
            per_slot_miss=tr.slot_misses / np.maximum(tr.slot_accesses, 1),
            ledger_delta=self.ledger.delta_since(base),
            per_tenant=self._per_tenant_counts(tr),
        )

    # ----------------------------------------- per-expert charge kernels
    # Both take the cache segment and ledger they charge explicitly, as
    # the reference's do (one pair per shard under expert parallelism).
    def _charge_expert_sync(self, tr: _StepTrace, lidx: int, e: int,
                            cache_seg, led: CostLedger, ntok: int,
                            lsb_wanted: set) -> bool:
        """Serialized-issue slice demand + matmul for one expert.
        Returns whether any of its slices missed."""
        missed = False
        key = SliceKey(lidx, e, "msb")
        nb = self._slice_nbytes(key)
        hit = cache_seg.access(key, nb)
        tr.accesses += 1
        if not hit:
            tr.misses += 1
            missed = True
            if key in cache_seg:       # fill landed
                led.miss_fill(nb)
            else:                      # dropped: direct stream
                led.flash_stream(nb)
        if hit or key in cache_seg:
            led.dram_read(nb)
        lsb_available = False
        if e in lsb_wanted and not self.ecfg.fused_slices:
            fetch = self.ecfg.policy.fetch_lsb_on_miss
            lkey = SliceKey(lidx, e, "lsb")
            lnb = self.store.slice_bytes(lkey)
            lhit = cache_seg.access(lkey, lnb, fill_on_miss=fetch)
            tr.accesses += 1
            if not lhit:
                tr.misses += 1
                missed = True
                if fetch:
                    if lkey in cache_seg:
                        led.miss_fill(lnb)
                    else:
                        led.flash_stream(lnb)
            if lhit or fetch:
                if lhit or lkey in cache_seg:
                    led.dram_read(lnb)
                lsb_available = True
        led.matmul(ntok, self.cfg.d_model,
                   self.expert_macs_per_token // self.cfg.d_model,
                   self._expert_bits(lsb_available))
        return missed

    def _charge_expert_async(self, tr: _StepTrace, lidx: int, e: int,
                             cache_seg, led: CostLedger, ntok: int,
                             lsb_wanted: set, t_route: float,
                             t_disp: Optional[float] = None) -> bool:
        """Event-timeline fill → read → matmul chain for one expert.
        ``t_disp``: all-to-all completion the matmul must additionally
        wait for (remote experts only).  Returns whether any of its
        slices missed."""
        missed = False
        key = SliceKey(lidx, e, "msb")
        nb = self._slice_nbytes(key)
        hit = cache_seg.access(key, nb)
        tr.accesses += 1
        if hit:
            # wait out an in-flight (prefetched) transfer
            t_data = max(t_route, cache_seg.ready_time(key))
            _, t_data = led.dram_read_at(t_data, nb)
        else:
            tr.misses += 1
            missed = True
            if key in cache_seg:        # fill landed
                _, fill_end = led.fill_at(t_route, nb)
                cache_seg.mark_inflight(key, fill_end)
                _, t_data = led.dram_read_at(fill_end, nb)
            else:                       # dropped: direct stream
                _, t_data = led.flash_stream_at(t_route, nb)
        lsb_available = False
        if e in lsb_wanted and not self.ecfg.fused_slices:
            fetch = self.ecfg.policy.fetch_lsb_on_miss
            lkey = SliceKey(lidx, e, "lsb")
            lnb = self.store.slice_bytes(lkey)
            lhit = cache_seg.access(lkey, lnb, fill_on_miss=fetch)
            tr.accesses += 1
            if lhit:
                t_lsb = max(t_route, cache_seg.ready_time(lkey))
                _, t_lsb = led.dram_read_at(t_lsb, lnb)
                t_data = max(t_data, t_lsb)
                lsb_available = True
            else:
                tr.misses += 1
                missed = True
                if fetch:
                    if lkey in cache_seg:
                        _, lf_end = led.fill_at(t_route, lnb)
                        cache_seg.mark_inflight(lkey, lf_end)
                        _, t_lsb = led.dram_read_at(lf_end, lnb)
                    else:
                        _, t_lsb = led.flash_stream_at(t_route, lnb)
                    t_data = max(t_data, t_lsb)
                    lsb_available = True
        led.matmul_at(
            t_data if t_disp is None else max(t_data, t_disp),
            ntok, self.cfg.d_model,
            self.expert_macs_per_token // self.cfg.d_model,
            self._expert_bits(lsb_available))
        return missed

    # -------------------------------------------- serialized (sync) replay
    def _charge_sync(self, tr: _StepTrace) -> StepCharge:
        base = self.ledger.snapshot()
        pf = self.prefetcher
        pf_req = pf is not None and pf.kind == "request"
        prev_used = None
        for period in range(tr.P):
            for pidx, pos in enumerate(self.moe_positions):
                lidx = self.layer_map[(pos, period)]
                # --- transition prefetch (paper §2.1 baseline): before
                # this layer runs, the predictor has pulled its guesses
                # into DRAM.  Residency-filtered, so every prediction is
                # a real fill; capacity-skipped ones moved no bytes and
                # do not count as issued.
                issued = None
                if pf is not None and not pf_req \
                        and prev_used is not None:
                    if self._partitioned:   # speculative: shared segment
                        self.cache.set_active_tenant(None)
                    predicted = pf.predict(
                        lidx - 1, prev_used,
                        resident=self._msb_resident_row(lidx))
                    issued = set()
                    for e in predicted:
                        key = SliceKey(lidx, int(e), "msb")
                        nb = self._slice_nbytes(key)
                        if key not in self.cache \
                                and nb <= self._segment_capacity(key):
                            self._ledger_for(lidx, int(e)).miss_fill(
                                nb, prefetch=True)
                            self.cache.insert(key, nb)
                            issued.add(int(e))
                    pf.mark_issued(len(issued))
                flat_ids, flat_gates, msb_demand, lsb_wanted, tok_per_e = \
                    self._layer_demand(tr, period, pidx)
                self.tracker.observe(lidx, flat_ids, flat_gates)
                # All-to-all token dispatch to remote experts (EP only).
                nb_a2a, _ = self._layer_a2a_demand(tr, period, pidx, lidx)
                if nb_a2a > 0:
                    self.ledger.ici_transfer(nb_a2a)
                if pf_req:
                    # Serialized fills land instantly, so a correct
                    # prediction that survived until its target layer is
                    # useful by definition (bar t_route=0).
                    self._prefetch_judge(lidx, msb_demand, lsb_wanted, 0.0)
                elif pf is not None:
                    if prev_used is not None:
                        pf.observe(lidx, prev_used, flat_ids)
                        demanded = set(int(e) for e in msb_demand)
                        pf.mark_useful(len(demanded & issued))
                        for e in sorted(issued - demanded):
                            pf.mark_wasted()
                            self._ledger_for(lidx, e).mark_prefetch_wasted(
                                self._slice_nbytes(SliceKey(lidx, e, "msb")))
                    prev_used = flat_ids

                owner = self._expert_owner(tr, period, pidx)
                rep = self._replica_targets(
                    lidx, tr.active[period, pidx] & tr.slot_mask[:, None],
                    tr.ids[period, pidx])
                missed_expert = np.zeros(self.n_experts, bool)
                missed_rep: dict = {}
                for e in msb_demand:
                    e = int(e)
                    if owner is not None:
                        self.cache.set_active_tenant(owner.get(e))
                    if e in rep:
                        # Replicated expert: each shard with tokens for
                        # it runs against its own replica + channels.
                        for sid, ntok in rep[e]:
                            if self._charge_expert_sync(
                                    tr, lidx, e, self.cache.shards[sid],
                                    self.ledger.shards[sid], ntok,
                                    lsb_wanted):
                                missed_rep.setdefault(e, set()).add(sid)
                    elif self._charge_expert_sync(
                            tr, lidx, e, self.cache,
                            self._ledger_for(lidx, e),
                            int(tok_per_e[e]), lsb_wanted):
                        missed_expert[e] = True
                # --- learn + issue for future layers (request kind):
                # plan() sees post-demand residency, so every candidate
                # is a fill that could save a future miss.
                if pf_req:
                    pf.observe(lidx, flat_ids, flat_gates,
                               crit_ids=lsb_wanted)
                    self._prefetch_issue(lidx, flat_ids, 0.0, tr,
                                         timeline=False)
                self._attribute_slot_misses(tr, period, pidx, missed_expert,
                                            missed_rep or None)
        self._charge_resident_sync(tr)
        return self._step_charge(tr, base)

    def _resident_token_share(self, tr: _StepTrace, sid: int) -> int:
        """Active tokens shard ``sid`` runs the dense (non-expert) layers
        for: slots are data-parallel round-robin across shards."""
        n = self._n_shards()
        if n == 1:
            return int(tr.slot_mask.sum())
        active_slots = np.nonzero(tr.slot_mask)[0]
        return int(np.count_nonzero(
            home_shard_of_token(active_slots, n) == sid))

    def _resident_shares(self, tr: _StepTrace):
        """``(ledger, token share)`` of each shard that runs a dense pass
        this step (one per shard, replicated dense weights)."""
        n = self._n_shards()
        for sid, led in enumerate(self._shard_ledgers()):
            share = self._resident_token_share(tr, sid)
            if n == 1:
                share = max(share, 1)   # single-device floor
            elif share == 0:
                continue    # no tokens homed here: no dense pass to run
            yield led, share

    def _charge_resident_sync(self, tr: _StepTrace) -> None:
        """Non-expert resident weights: one pass per decode step per
        shard."""
        for led, share in self._resident_shares(tr):
            led.dram_read(self.resident_bytes)
            led.matmul(share, self.cfg.d_model,
                       int(self.resident_bytes / self.cfg.d_model) + 1, 8)

    # ------------------------------------------- pipelined (async) replay
    def _charge_async(self, tr: _StepTrace) -> StepCharge:
        """Event-timeline replay: the double-buffered layer pipeline.

        Per flat layer (execution order):

        1. the layer's routing is known once the previous layer's compute
           drains (``t_route``); demand fills issue on the Flash channel
           at that instant and each expert's DRAM read / matmul chain
           follows its own data dependencies — expert ``e+1``'s fill
           overlaps expert ``e``'s read and compute;
        2. prefetch fills for later layers (predicted from this layer's
           routing, residency-filtered) are enqueued on the Flash
           channel behind this layer's demand fills and marked in-flight
           in the cache; a consumer that arrives before a prefetched
           transfer lands stalls only for the remaining tail;
        3. a prediction is **useful** iff its transfer landed before its
           consuming layer started, **late** if demanded but still in
           flight, **wasted** if never demanded (its Flash/DRAM energy is
           attributed to ``prefetch_wasted_energy_j``).

        The resident (non-expert) weight stream for the step is issued
        once behind the expert reads and overlaps expert compute.

        Under expert parallelism every per-expert chain issues on the
        owning shard's channel clocks, so the step's latency is the max
        over shard timelines plus the all-to-all dispatch, which each
        remote expert's matmul waits for.
        """
        base = self.ledger.snapshot()
        t_step = self._compute_frontier()
        pf = self.prefetcher
        pf_req = pf is not None and pf.kind == "request"
        prev_used = None
        # Transition-kind prefetches in flight: key -> (ready_t, nbytes)
        # per target layer.  Step-local: the Markov baseline only ever
        # targets the next layer of the same step.  The request kind
        # uses the engine-level ``_pf_pending`` instead (cyclic targets
        # cross the step boundary).
        pending: dict = {}
        for period in range(tr.P):
            for pidx, pos in enumerate(self.moe_positions):
                lidx = self.layer_map[(pos, period)]
                t_route = max(t_step, self._compute_frontier())
                flat_ids, flat_gates, msb_demand, lsb_wanted, tok_per_e = \
                    self._layer_demand(tr, period, pidx)
                self.tracker.observe(lidx, flat_ids, flat_gates)
                # All-to-all token dispatch, issued the moment routing is
                # known; only experts that receive remote tokens wait for
                # it (t_disp).
                nb_a2a, remote_experts = self._layer_a2a_demand(
                    tr, period, pidx, lidx)
                t_disp = t_route
                if nb_a2a > 0:
                    _, t_disp = self.ledger.ici_transfer_at(t_route, nb_a2a)

                # --- prefetch usefulness for THIS layer, judged before
                # demand charging mutates the cache.  The bar is t_route
                # — when the consuming layer starts.
                demanded = set(int(e) for e in msb_demand)
                if pf_req:
                    self._prefetch_judge(lidx, msb_demand, lsb_wanted,
                                         t_route)
                else:
                    for key, (ready_t, p_nb) in \
                            pending.pop(lidx, {}).items():
                        if key not in self.cache:  # evicted before use
                            pf.mark_wasted()
                            self._ledger_for(
                                key.layer,
                                key.expert).mark_prefetch_wasted(p_nb)
                        elif key.expert in demanded:
                            if ready_t <= t_route:
                                pf.mark_useful()
                            else:
                                pf.mark_late()
                        else:
                            pf.mark_wasted()
                            self._ledger_for(
                                key.layer,
                                key.expert).mark_prefetch_wasted(p_nb)

                owner = self._expert_owner(tr, period, pidx)
                rep = self._replica_targets(
                    lidx, tr.active[period, pidx] & tr.slot_mask[:, None],
                    tr.ids[period, pidx])
                missed_expert = np.zeros(self.n_experts, bool)
                missed_rep: dict = {}
                for e in msb_demand:
                    e = int(e)
                    if owner is not None:
                        self.cache.set_active_tenant(owner.get(e))
                    if e in rep:
                        # Replicated expert: each shard with tokens for it
                        # chains against its own replica + channels and
                        # never waits on the dispatch.
                        for sid, ntok in rep[e]:
                            if self._charge_expert_async(
                                    tr, lidx, e, self.cache.shards[sid],
                                    self.ledger.shards[sid], ntok,
                                    lsb_wanted, t_route):
                                missed_rep.setdefault(e, set()).add(sid)
                    elif self._charge_expert_async(
                            tr, lidx, e, self.cache,
                            self._ledger_for(lidx, e), int(tok_per_e[e]),
                            lsb_wanted, t_route,
                            t_disp if e in remote_experts else None):
                        missed_expert[e] = True
                # --- learn + issue prefetch for future layers, behind
                # this layer's demand fills on each shard's Flash channel.
                if pf_req:
                    pf.observe(lidx, flat_ids, flat_gates,
                               crit_ids=lsb_wanted)
                    self._prefetch_issue(lidx, flat_ids, t_route, tr,
                                         timeline=True)
                elif pf is not None:
                    if prev_used is not None:
                        pf.observe(lidx, prev_used, flat_ids)
                    prev_used = flat_ids
                    if lidx + 1 < self.n_moe_layers:
                        if self._partitioned:   # speculative: shared seg
                            self.cache.set_active_tenant(None)
                        predicted = pf.predict(
                            lidx, flat_ids,
                            resident=self._msb_resident_row(lidx + 1))
                        n_issued = 0
                        for e in predicted:
                            key = SliceKey(lidx + 1, int(e), "msb")
                            nb = self._slice_nbytes(key)
                            if key in self.cache \
                                    or nb > self._segment_capacity(key):
                                continue
                            _, end = self._ledger_for(
                                lidx + 1, int(e)).fill_at(
                                    t_route, nb, prefetch=True)
                            self.cache.insert(key, nb)
                            self.cache.mark_inflight(key, end)
                            pending.setdefault(lidx + 1, {})[key] = (end, nb)
                            n_issued += 1
                        pf.mark_issued(n_issued)
                self._attribute_slot_misses(tr, period, pidx, missed_expert,
                                            missed_rep or None)
        # Transition-kind prefetch targets lidx+1 (< n_moe_layers), which
        # always runs later in the same step and pops its pending entries
        # — so issued == useful + late + wasted holds per step.
        assert not pending, f"unconsumed prefetch bookkeeping: {pending}"
        # Resident (non-expert) weights stream behind the expert reads
        # and overlap expert compute; the dense step compute waits on
        # them (per shard, tokens split data-parallel).
        for led, share in self._resident_shares(tr):
            _, res_ready = led.dram_read_at(t_step, self.resident_bytes)
            led.matmul_at(res_ready, share, self.cfg.d_model,
                          int(self.resident_bytes / self.cfg.d_model) + 1, 8)
        self.cache.settle(self.ledger.now)
        return self._step_charge(tr, base)


class SliceMoEEngine(PersistentEngine):
    """Single-request convenience API (the paper's Fig. 1a deployment):
    one request's ``kv_cache``, controller and ``alpha`` on top of the
    shared :class:`PersistentEngine`."""

    def __init__(self, cfg: ModelConfig, params: dict, ecfg: EngineConfig,
                 *, device=None):
        super().__init__(cfg, params, ecfg, device=device)
        self.controller = self.new_controller()
        self.alpha = 0.0

    def prefill(self, tokens):
        """Run prefill; simulate layer-streaming cache fills; apply warmup."""
        logits, self.kv_cache, info = self.run_prefill(tokens)
        self.warmup_summary = info["warmup"]
        self.prefill_snapshot = info["snapshot"]
        return logits

    def decode(self, first_token: torch.Tensor, n_steps: int):
        """Greedy decode ``n_steps`` tokens with full offload simulation.

        Returns (tokens [B, n_steps], metrics dict).
        """
        token = torch.as_tensor(first_token, device=self.device)
        tokens_out = []
        step_metrics = []
        for _ in range(n_steps):
            logits, self.kv_cache, aux = self._decode(
                token, self.kv_cache, self.alpha, None)
            token = torch.argmax(logits, dim=-1)
            tokens_out.append(token)
            charge = self.charge_decode_step(aux)
            step_miss = charge.miss_rate
            if self.controller is not None:
                self.alpha = self.controller.update(step_miss)
            step_metrics.append({
                "miss_rate": step_miss,
                "alpha": self.alpha,
                **charge.ledger_delta,
            })
        metrics = {
            "per_step": step_metrics,
            "cache_stats": self.cache.stats.snapshot(),
            "decode_totals": self.ledger.delta_since(self.prefill_snapshot),
        }
        return torch.stack(tokens_out, dim=1), metrics
