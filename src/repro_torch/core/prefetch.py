"""Predictive expert prefetching: the Markov baseline and its replacement
(port of ``repro.core.prefetch``, numpy only).

Two predictors live here:

* :class:`TransitionPrefetcher` — the single-step layer-transition
  model (Pre-gated-MoE / ProMoE style) the paper's §2.1 argues against.
  Kept as the measured baseline: the serving benchmark shows it at 0%
  accuracy (0 useful / 21 late / 75 wasted of 96 fills) because a fill
  issued one layer ahead almost never lands before the consuming layer
  routes in the I/O-bound decode regime.

* :class:`RequestPrefetcher` over :class:`ActivationPredictor` — the
  sparsity-aware, request-level activation model (MoE-Infinity, arXiv
  2401.14361): per-request expert-activation matrices accumulated across
  layers from prefill routing onward, multi-layer-ahead candidate
  scoring (decayed request-level activation blended with the global
  transition prior), slice-granular issuance ranked by expected benefit
  per Flash byte, and confidence gating so low-evidence layers issue
  nothing.  Crucially it predicts *across decode-step boundaries*
  (cyclic layer targets), which buys a fill an entire step of slack —
  the only distance at which a prefetch can land before its consumer in
  a 99.5%-I/O-stalled pipeline.

Paper §2.1: "Predictive schemes such as prefetching and speculative
caching [17-20] improve locality but become increasingly unreliable in
modern MoE … strong router regularization leads to stochastic routing
patterns and frequent prefetch failures."

We implement the standard layer-transition predictor (Pre-gated-MoE /
ProMoE style): an online co-occurrence model
``P(expert_j at layer l+1 | expert_i at layer l)`` trained on observed
routing traces, used during decode to pull the top-m predicted experts
of the next layer into DRAM before that layer executes.  Mispredictions
cost real Flash reads (charged to the ledger) without saving future
misses — exactly the failure mode the paper describes for
diversity-regularized routers.

On the asynchronous decode timeline (``EngineConfig.async_io``) each
prediction becomes a fill issued on the Flash channel *behind* the
current layer's demand fills; the engine classifies every issued
prefetch into one of three outcomes:

* **useful** — the predicted slice was demanded by its consuming layer
  and its transfer landed before that layer started;
* **late** — demanded, but the transfer was still in flight when the
  layer needed it (the layer stalls on the tail of the transfer; some
  latency is still hidden, but the paper's "before the layer starts"
  usefulness bar is missed);
* **wasted** — never demanded: pure Flash/DRAM energy burned
  (``CostLedger.prefetch_wasted_energy_j``).

Outcomes are judged against the *predicted consuming layer* (the next
layer of the current step), the paper's §2.1 usefulness bar.  A
"wasted" fill whose slice survives in the cache and serves a *later*
step's demand shows up as an ordinary demand hit — that residual
benefit is credited to the cache, not to the prefetcher, and its fill
energy stays attributed as prefetch waste.

Two fixes over the original implementation (both regression-tested):

1. ``predict`` takes an optional **residency mask** — predicting an
   expert that is already cached wastes a prefetch slot on a guaranteed
   no-op, crowding out predictions that could actually save a miss;
2. ties are broken by a **seeded random permutation** instead of
   ``argsort``'s index order.  Under the uniform smoothing prior a cold
   predictor used to emit experts ``0..m-1`` every time, systematically
   (and invisibly) favoring low-numbered experts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.slices import SliceKey


@dataclasses.dataclass
class TransitionPrefetcher:
    kind = "transition"

    n_layers: int
    n_experts: int
    top_m: int = 4
    smoothing: float = 0.1
    seed: int = 0
    # Confidence floor: a layer transition must have been observed at
    # least this many times before predict() issues for it.  With 0 the
    # cold predictor guesses from the uniform smoothing prior — near-
    # random fills that burn Flash energy with ~no chance of saving a
    # miss (the paper's §2.1 "frequent prefetch failures").
    min_transitions: int = 0

    def __post_init__(self):
        # counts[l, i, j]: expert i used at layer l, expert j at layer l+1
        self.counts = np.full(
            (max(self.n_layers - 1, 1), self.n_experts, self.n_experts),
            self.smoothing)
        # obs[l]: observed (layer l -> l+1) transition events — the
        # confidence-floor denominator (smoothing prior excluded).
        self.obs = np.zeros(max(self.n_layers - 1, 1), np.int64)
        self._rng = np.random.default_rng(self.seed)
        self.issued = 0
        self.useful = 0
        self.late = 0
        self.wasted = 0

    def _valid_ids(self, experts: np.ndarray) -> np.ndarray:
        """Unique in-range expert ids.  ``mask_routing`` emits the
        sentinel id ``n_experts`` for padding slots; indexing the
        transition counts with it used to raise IndexError, so masked
        slots are dropped here instead."""
        ids = np.unique(np.asarray(experts).reshape(-1))
        return ids[(ids >= 0) & (ids < self.n_experts)]

    # --------------------------------------------------------------- learn
    def observe(self, layer: int, prev_experts: np.ndarray,
                cur_experts: np.ndarray) -> None:
        """Record a (layer-1 -> layer) transition from a routing trace."""
        if layer <= 0 or layer > self.counts.shape[0]:
            return
        pe = self._valid_ids(prev_experts)
        ce = self._valid_ids(cur_experts)
        if pe.size == 0 or ce.size == 0:
            return
        self.counts[layer - 1][np.ix_(pe, ce)] += 1.0
        self.obs[layer - 1] += 1

    # -------------------------------------------------------------- predict
    def predict(self, layer: int, cur_experts: np.ndarray,
                resident: Optional[np.ndarray] = None) -> np.ndarray:
        """Top-m predicted experts for ``layer + 1``.

        ``resident``: optional ``[n_experts]`` bool mask of experts whose
        target slice is already cached — they are excluded so every
        returned prediction corresponds to a fill that could save a miss.
        Score ties are broken by a seeded random permutation (drawn per
        call, deterministic for a given construction seed and call
        sequence), not by expert index.
        """
        # n_layers - 1, not counts.shape[0]: the counts buffer is floored
        # to one transition matrix, so a 1-layer model would otherwise
        # "predict" for a layer that does not exist.
        if layer < 0 or layer >= self.n_layers - 1:
            return np.empty(0, np.int64)
        # Confidence floor: stay silent until this transition has enough
        # real observations that the scores are no longer the prior.
        if self.obs[layer] < self.min_transitions:
            return np.empty(0, np.int64)
        ce = self._valid_ids(cur_experts)
        if ce.size == 0:
            return np.empty(0, np.int64)
        scores = self.counts[layer][ce].sum(axis=0)
        candidates = np.arange(self.n_experts)
        if resident is not None:
            keep = ~np.asarray(resident, bool)
            candidates = candidates[keep]
            scores = scores[keep]
        if candidates.size == 0:
            return np.empty(0, np.int64)
        perm = self._rng.permutation(candidates.size)
        order = perm[np.argsort(-scores[perm], kind="stable")]
        return candidates[order[: self.top_m]].astype(np.int64)

    def clone(self) -> "TransitionPrefetcher":
        """Deep copy (transition counts, rng state, outcome counters) so a
        forked replay simulation keeps an independent predictor whose tie
        -break stream continues deterministically from the fork point."""
        import copy

        return copy.deepcopy(self)

    # ------------------------------------------------------ interface shims
    # The engine drives both predictor kinds through one surface; the
    # request-level hooks are no-ops on the transition baseline, so old
    # recorded traces replay bit-identically.
    def begin_request(self, decay: float) -> None:
        pass

    def observe_prefill(self, layer: int, ids: np.ndarray,
                        gates: np.ndarray,
                        n_tokens: Optional[int] = None) -> None:
        pass

    @property
    def in_flight(self) -> int:
        """Issued fills not yet judged.  The transition baseline only
        targets the next layer of the same step, which always judges
        before the step ends — so this is 0 between steps."""
        return self.issued - self.useful - self.late - self.wasted

    # ---------------------------------------------------------- accounting
    def mark_issued(self, n: int = 1) -> None:
        self.issued += n

    def mark_useful(self, n: int = 1) -> None:
        self.useful += n

    def mark_late(self, n: int = 1) -> None:
        self.late += n

    def mark_wasted(self, n: int = 1) -> None:
        self.wasted += n

    @property
    def accuracy(self) -> float:
        return self.useful / max(self.issued, 1)

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "issued": self.issued,
            "useful": self.useful,
            "late": self.late,
            "wasted": self.wasted,
            "in_flight": self.in_flight,
            "accuracy": self.accuracy,
            "min_transitions": self.min_transitions,
            "observed_transitions": int(self.obs.sum()),
        }


# --------------------------------------------------------------------------
# Request-level activation prediction (MoE-Infinity style)
# --------------------------------------------------------------------------

def _valid_unique(experts: np.ndarray, n_experts: int) -> np.ndarray:
    """Unique in-range ids; drops the ``n_experts`` padding sentinel."""
    ids = np.unique(np.asarray(experts).reshape(-1))
    return ids[(ids >= 0) & (ids < n_experts)]


@dataclasses.dataclass
class ActivationPredictor:
    """Request-level expert-activation model over the flat MoE layers.

    State (all ``[n_layers, n_experts]`` unless noted):

    * ``act`` — decayed gate-mass per (layer, expert): seeded from
      prefill routing, EMA-updated each decode observation, aged by
      ``begin_request`` at request boundaries so the matrix tracks the
      *current* request mix rather than the all-time average — the
      "activation matrix" of MoE-Infinity.
    * ``freq`` — decayed per-step demand *indicator* EMA per (layer,
      expert): unlike ``act`` (a share of gate mass), this estimates
      ``P(expert demanded at the layer's next execution)`` directly,
      which is the probability a prefetch outcome is judged on.  An
      expert the batch touches every step scores ~1 here even when its
      gate share is small — exactly the slice worth re-filling after
      an eviction.
    * ``trans`` — global cyclic transition prior ``[n_layers, E, E]``:
      ``trans[l]`` counts expert co-occurrence from layer ``l`` to the
      *next observed* layer ``(l+1) % n_layers`` — the wrap row learns
      the cross-step transition the Markov baseline cannot express.
      Never decayed (it is a property of the router, not the request).
    * ``sel`` / ``crit`` — per-expert selection and critical-selection
      mass, aged with ``act``; their ratio estimates how often an
      expert's selection is critical, i.e. whether its LSB slice is
      worth prefetching (DBSC demand prediction).
    * ``obs`` ``[n_layers]`` — cumulative observation count per layer,
      the confidence-gate denominator (never decayed, mirroring the
      transition baseline's ``min_transitions`` semantics).

    The predictor is deliberately *aggregate* across concurrent
    requests: decode steps are batched, so per-slot attribution does not
    exist in the charge path — the matrix models the in-flight request
    mix, aged at admission boundaries.
    """

    n_layers: int
    n_experts: int
    ema: float = 0.3            # within-request EMA weight per observation
    request_weight: float = 0.7  # blend: request activation share ...
    prior_weight: float = 0.3    # ... vs global transition-prior share
    smoothing: float = 0.1       # transition-prior Laplace smoothing
    seed: int = 0

    def __post_init__(self):
        L, E = self.n_layers, self.n_experts
        self.act = np.zeros((L, E))
        self.freq = np.zeros((L, E))
        self.pfrac = np.zeros((L, E))   # most recent admission's prefill frac
        self.sel = np.zeros((L, E))
        self.crit = np.zeros((L, E))
        self.trans = np.full((L, E, E), self.smoothing)
        self.obs = np.zeros(L, np.int64)
        self._prev: Optional[tuple] = None   # (layer, ids) last observed
        self._rng = np.random.default_rng(self.seed)

    # --------------------------------------------------------------- learn
    def begin_request(self, decay: float) -> None:
        """Age the request-level state at a request boundary (same decay
        the engine applies to cache hotness): the new request inherits a
        faded picture of the in-flight mix, not a blank slate."""
        self.act *= decay
        self.freq *= decay
        self.sel *= decay
        self.crit *= decay
        self.pfrac[:] = 0.0      # admission-time signal is per-request only
        self._prev = None        # don't learn transitions across requests

    def _mass(self, ids: np.ndarray, gates: np.ndarray) -> np.ndarray:
        """Per-expert gate mass of one layer's routing, L1-normalised so
        a layer's activation row is a share distribution regardless of
        batch occupancy."""
        m = np.zeros(self.n_experts)
        ids = np.asarray(ids).reshape(-1)
        gates = np.asarray(gates, np.float64).reshape(-1)
        ok = (ids >= 0) & (ids < self.n_experts)
        np.add.at(m, ids[ok], np.abs(gates[ok]))
        tot = m.sum()
        return m / tot if tot > 0 else m

    def observe_prefill(self, layer: int, ids: np.ndarray,
                        gates: np.ndarray,
                        n_tokens: Optional[int] = None) -> None:
        """Seed the activation matrix from prompt routing — the signal
        MoE-Infinity shows is already predictive of the whole request's
        decode routing.  The demand-frequency row is seeded with each
        expert's *per-token* selection fraction, not a whole-prompt
        indicator: nearly every expert appears somewhere in a long
        prompt, but only per-token rates transfer to per-decode-step
        demand probability."""
        if not (0 <= layer < self.n_layers):
            return
        mass = self._mass(ids, gates)
        if mass.sum() == 0:
            return
        self.act[layer] = 0.5 * self.act[layer] + 0.5 * mass
        ids_flat = np.asarray(ids).reshape(-1)
        ids_flat = ids_flat[(ids_flat >= 0) & (ids_flat < self.n_experts)]
        if n_tokens is None:
            n_tokens = ids_flat.size
        cnt = np.bincount(ids_flat, minlength=self.n_experts)
        frac = np.clip(cnt / max(int(n_tokens), 1), 0.0, 1.0)
        self.freq[layer] = 0.5 * self.freq[layer] + 0.5 * frac
        self.pfrac[layer] = frac
        self.sel[layer] += mass
        self.obs[layer] += 1

    def observe(self, layer: int, ids: np.ndarray, gates: np.ndarray,
                crit_ids: Optional[Sequence[int]] = None) -> None:
        """One decode step's routing at ``layer``: EMA the activation
        row, count the cyclic transition from the previously observed
        layer, and accumulate critical-selection mass (``crit_ids`` —
        the experts whose LSB slice the layer demanded)."""
        if not (0 <= layer < self.n_layers):
            return
        mass = self._mass(ids, gates)
        used = _valid_unique(ids, self.n_experts)
        if mass.sum() > 0:
            self.act[layer] = (1 - self.ema) * self.act[layer] \
                + self.ema * mass
            self.freq[layer] = (1 - self.ema) * self.freq[layer]
            self.freq[layer][used] += self.ema
            self.obs[layer] += 1
        self.sel[layer][used] += 1.0
        if crit_ids is not None:
            ce = _valid_unique(np.asarray(list(crit_ids), np.int64),
                               self.n_experts)
            self.crit[layer][ce] += 1.0
        if self._prev is not None:
            pl, pe = self._prev
            if (pl + 1) % self.n_layers == layer and pe.size \
                    and used.size:
                self.trans[pl][np.ix_(pe, used)] += 1.0
        self._prev = (layer, used)

    # ------------------------------------------------------------- predict
    def _prior_chain(self, from_layer: int, from_ids: np.ndarray,
                     distance: int) -> np.ndarray:
        """Propagate the current layer's expert set ``distance`` hops
        through the cyclic transition prior; returns an ``[E]`` share
        distribution over experts at layer
        ``(from_layer + distance) % n_layers``."""
        v = np.zeros(self.n_experts)
        ids = _valid_unique(from_ids, self.n_experts)
        if ids.size == 0:
            return v
        v[ids] = 1.0 / ids.size
        for h in range(distance):
            mat = self.trans[(from_layer + h) % self.n_layers]
            v = v @ mat
            tot = v.sum()
            if tot <= 0:
                return np.zeros(self.n_experts)
            v /= tot
        return v

    def scores(self, from_layer: int, from_ids: np.ndarray,
               distance: int) -> np.ndarray:
        """Blended ``[E]`` candidate scores for the layer ``distance``
        hops ahead (cyclically — distances ≥ the remaining layers of
        this step target the *next* decode step).  The request component
        is the demand-frequency EMA (≈ P(demanded at the target's next
        execution) — what outcomes are judged on); the prior component
        is the propagated transition share.  Scores live in [0, 1], so
        one ``min_score`` threshold is meaningful across layers."""
        target = (from_layer + distance) % self.n_layers
        prior = self._prior_chain(from_layer, from_ids, distance)
        return self.request_weight * self.freq[target] \
            + self.prior_weight * prior

    def crit_frac(self, layer: int) -> np.ndarray:
        """[E] estimate of P(selection is critical) per expert — the
        LSB-demand predictor (a controller-demoted fleet stops demanding
        LSBs, so this decays toward 0 and LSB prefetch dries up)."""
        return self.crit[layer] / np.maximum(self.sel[layer], 1e-12)

    def clone(self) -> "ActivationPredictor":
        import copy

        return copy.deepcopy(self)


@dataclasses.dataclass
class RequestPrefetcher:
    """Issuance policy + outcome accounting over an
    :class:`ActivationPredictor`.

    ``plan`` returns at most ``top_m`` :class:`SliceKey` candidates per
    call, ranked by **expected benefit per Flash byte**:

    ``score(e, target) x P(useful | distance) / slice_bytes``

    where ``score`` is the predictor's blended activation share and
    ``P(useful | distance)`` is learned online from this run's own
    outcome history (Laplace-smoothed useful/issued per lookahead
    distance) — a near-target fill that keeps landing late stops being
    issued without any hand-tuned timing model.

    Gates, in order:

    * confidence — a target layer with fewer than ``min_obs``
      observations issues nothing (generalises the transition
      baseline's ``prefetch_min_obs``);
    * ``min_score`` — activation-share floor, so the cold/uniform tail
      never burns Flash energy (the paper's §2.1 failure mode);
    * residency + in-flight — a candidate already cached or already
      pending is a guaranteed no-op and is skipped *before* the budget
      is spent;
    * LSB candidates only when the caller allows them (DBSC mode,
      un-demoted) and the expert's learned critical fraction clears
      ``lsb_crit_frac``.
    """

    n_layers: int
    n_experts: int
    top_m: int = 4
    lookahead: int = 2
    min_obs: int = 0
    min_score: float = 0.02
    lsb_crit_frac: float = 0.5
    ema: float = 0.3
    request_weight: float = 0.7
    prior_weight: float = 0.3
    seed: int = 0

    kind = "request"

    def __post_init__(self):
        self.predictor = ActivationPredictor(
            self.n_layers, self.n_experts, ema=self.ema,
            request_weight=self.request_weight,
            prior_weight=self.prior_weight, seed=self.seed)
        self._rng = np.random.default_rng(self.seed + 1)
        # outcome counters + per-distance usefulness (Laplace prior 1/2)
        self.issued = 0
        self.useful = 0
        self.late = 0
        self.wasted = 0
        self.in_flight = 0
        # Distance buckets: index 0 is the prefill-seeded (admission-time)
        # bucket, 1..lookahead are decode-time issuance distances.
        d = max(self.lookahead, 1)
        self.dist_issued = np.zeros(d + 1, np.int64)
        self.dist_useful = np.zeros(d + 1, np.int64)

    # --------------------------------------------------------------- learn
    def begin_request(self, decay: float) -> None:
        self.predictor.begin_request(decay)

    def observe_prefill(self, layer: int, ids: np.ndarray,
                        gates: np.ndarray,
                        n_tokens: Optional[int] = None) -> None:
        self.predictor.observe_prefill(layer, ids, gates,
                                       n_tokens=n_tokens)

    def observe(self, layer: int, ids: np.ndarray, gates: np.ndarray,
                crit_ids: Optional[Sequence[int]] = None) -> None:
        self.predictor.observe(layer, ids, gates, crit_ids=crit_ids)

    # ---------------------------------------------------------------- plan
    def _p_useful(self, distance: int) -> float:
        """Learned P(useful | lookahead distance), Laplace-smoothed with
        an optimistic prior so every distance gets explored before the
        outcome history can demote it.  Distance 0 is the prefill-seeded
        bucket."""
        i = self.dist_issued[min(distance, len(self.dist_issued) - 1)]
        u = self.dist_useful[min(distance, len(self.dist_useful) - 1)]
        return float((u + 1.0) / (i + 2.0))

    def _gate(self, score: float, p_use: float) -> bool:
        """Confidence-weighted admission floor.  The raw score is scaled
        by ``(p_useful / 0.5)**2`` (squared deviation from the Laplace
        prior), so a cold distance is gated on score alone while a
        distance whose fills keep landing late or wasted needs a
        rapidly stronger score to keep issuing — structurally-always-
        late distances throttle themselves off within a few fills."""
        return score * (p_use / 0.5) ** 2 >= self.min_score

    def plan(self, from_layer: int, from_ids: np.ndarray, *,
             is_resident: Callable[[SliceKey], bool],
             slice_bytes: Callable[[SliceKey], float],
             pending: Sequence[SliceKey] = (),
             lsb_allowed: bool = False) -> List[tuple]:
        """Rank prefetch candidates after ``from_layer`` routed.

        Returns ``[(SliceKey, distance), ...]`` (≤ ``top_m``), best
        expected-benefit-per-byte first.  The caller charges the fills
        (capacity permitting) and reports issuance via ``mark_issued``.
        """
        pend = set(pending)
        cands: List[tuple] = []   # (benefit_per_byte, jitter, key, dist)
        pred = self.predictor
        for d in range(1, max(self.lookahead, 1) + 1):
            target = (from_layer + d) % self.n_layers
            if d > 1 and target == (from_layer + 1) % self.n_layers:
                break            # n_layers == 1: distances alias
            if pred.obs[target] < self.min_obs:
                continue         # confidence gate: not enough evidence
            scores = pred.scores(from_layer, from_ids, d)
            p_use = self._p_useful(d)
            crit = pred.crit_frac(target) if lsb_allowed else None
            for e in np.nonzero(scores > 0)[0]:
                e = int(e)
                if not self._gate(scores[e], p_use):
                    continue
                key = SliceKey(target, e, "msb")
                if key not in pend and not is_resident(key):
                    nb = max(slice_bytes(key), 1e-12)
                    cands.append((scores[e] * p_use / nb,
                                  self._rng.random(), key, d))
                if crit is not None and crit[e] >= self.lsb_crit_frac:
                    lkey = SliceKey(target, e, "lsb")
                    if lkey not in pend and not is_resident(lkey):
                        lnb = max(slice_bytes(lkey), 1e-12)
                        cands.append(
                            (scores[e] * crit[e] * p_use / lnb,
                             self._rng.random(), lkey, d))
        cands.sort(key=lambda c: (-c[0], c[1]))
        return [(key, d) for _, _, key, d in cands[: self.top_m]]

    def plan_prefill(self, *, is_resident: Callable[[SliceKey], bool],
                     slice_bytes: Callable[[SliceKey], float],
                     pending: Sequence[SliceKey] = (),
                     budget: Optional[int] = None) -> List[tuple]:
        """Admission-time issuance from the freshly seeded activation
        matrix, called once per request after the prefill charge and the
        warmup reshape have settled residency.

        A request's prompt routing is already predictive of its decode
        routing (MoE-Infinity's key observation; measured here at
        P(demanded within 3 steps) ≈ 0.8 for per-token selection
        fractions ≥ 0.15), and the warmup reshape keeps *globally* hot
        experts — evicting exactly the request-specific experts this
        request will re-demand.  Candidates are scored by the *fresh*
        per-token selection fraction of the admission's own prompt
        (``pfrac`` — not the cross-request ``freq`` EMA, whose stale
        mass from departed tenants is exactly the wasted-fill tail)
        across **all** layers at once (distance bucket 0), ranked by
        expected benefit per Flash byte, with a per-request budget of
        ``top_m x n_layers`` fills.

        Returns ``[(SliceKey, 0), ...]`` like :meth:`plan`.
        """
        pend = set(pending)
        pred = self.predictor
        p_use = self._p_useful(0)
        cands: List[tuple] = []
        for layer in range(self.n_layers):
            if pred.obs[layer] < self.min_obs:
                continue
            scores = self.request_weight * pred.pfrac[layer]
            for e in np.nonzero(scores > 0)[0]:
                e = int(e)
                if not self._gate(scores[e], p_use):
                    continue
                key = SliceKey(layer, e, "msb")
                if key not in pend and not is_resident(key):
                    nb = max(slice_bytes(key), 1e-12)
                    cands.append((scores[e] * p_use / nb,
                                  self._rng.random(), key))
        cands.sort(key=lambda c: (-c[0], c[1]))
        if budget is None:
            budget = self.top_m * self.n_layers
        return [(key, 0) for _, _, key in cands[:budget]]

    # ---------------------------------------------------------- accounting
    def mark_issued(self, n: int = 1, distance: int = 1) -> None:
        self.issued += n
        self.in_flight += n
        self.dist_issued[min(distance, len(self.dist_issued) - 1)] += n

    def mark_useful(self, n: int = 1, distance: int = 1) -> None:
        self.useful += n
        self.in_flight -= n
        self.dist_useful[min(distance, len(self.dist_useful) - 1)] += n

    def mark_late(self, n: int = 1, distance: int = 1) -> None:
        self.late += n
        self.in_flight -= n

    def mark_wasted(self, n: int = 1, distance: int = 1) -> None:
        self.wasted += n
        self.in_flight -= n

    @property
    def accuracy(self) -> float:
        return self.useful / max(self.issued, 1)

    def clone(self) -> "RequestPrefetcher":
        """Deep copy: predictor matrices, rng streams, outcome counters.
        A forked replay's predictor evolves independently from the fork
        point (asserted by the invariant suite)."""
        import copy

        return copy.deepcopy(self)

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "issued": self.issued,
            "useful": self.useful,
            "late": self.late,
            "wasted": self.wasted,
            "in_flight": self.in_flight,
            "accuracy": self.accuracy,
            "min_obs": self.min_obs,
            "lookahead": self.lookahead,
            "min_score": self.min_score,
            "observed_layers": int(self.predictor.obs.sum()),
            # index 0: prefill-seeded (admission-time) fills; 1..lookahead:
            # decode-time issuance distances.
            "p_useful_by_distance": [
                round(self._p_useful(d), 4)
                for d in range(len(self.dist_issued))],
        }
