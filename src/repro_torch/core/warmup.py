"""Predictive Cache Warmup — PCW (paper §4.3).

During prefill the engine accumulates per-(layer, expert) access frequency
("prefill hotness").  At the prefill→decode transition PCW reshapes the
unified cache into a hotness-aligned state:

  1. evict LSB slices of experts whose hotness is below the critical
     quantile (they contribute least to accuracy — paper: "starting from
     LSB slices"),
  2. evict MSB slices with low prefill access frequency next,
  3. re-order the LRU recency of what remains by hotness, so the first
     decode evictions hit the coldest slices,
  4. (optionally) pre-install hot MSB slices that prefill's layer-by-layer
     streaming already paid to load — the "reshape, don't refill" step.

The ratio of experts retaining their LSB (i.e. staying high-bit) is tied to
the DBSC single-head threshold: on average fewer than one expert per token
is critical, so only the hottest ``lsb_keep_frac`` keep their LSBs.

Baseline initial states for Fig. 10: ``empty``, ``last_layer``, ``random``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.cache import SliceCache
from repro_torch.core.slices import ExpertSliceStore, SliceKey


@dataclasses.dataclass
class HotnessTracker:
    """Per-(layer, expert) EMA of selection frequency, gate-mass weighted."""

    n_layers: int
    n_experts: int
    decay: float = 0.95

    def __post_init__(self):
        self.counts = np.zeros((self.n_layers, self.n_experts))
        self.gate_mass = np.zeros((self.n_layers, self.n_experts))

    def observe(self, layer: int, expert_ids: np.ndarray,
                gates: np.ndarray) -> None:
        """expert_ids/gates: [T, k] for the tokens routed this call.

        Out-of-range ids are dropped, not counted: ``mask_routing``
        redirects padding slots to the sentinel id ``n_experts``, which
        used to raise IndexError from ``np.add.at`` when a caller passed
        unfiltered routing arrays.
        """
        ids = np.asarray(expert_ids).reshape(-1)
        g = np.asarray(gates).reshape(-1)
        valid = (ids >= 0) & (ids < self.n_experts)
        if not valid.all():
            ids, g = ids[valid], g[valid]
        np.add.at(self.counts[layer], ids, 1.0)
        np.add.at(self.gate_mass[layer], ids, g)

    def step_decay(self) -> None:
        self.counts *= self.decay
        self.gate_mass *= self.decay

    def begin_request(self, decay: float = 0.5) -> None:
        """Age accumulated hotness at a request boundary.

        The persistent engine keeps one tracker across requests so PCW can
        reshape from *accumulated* traffic rather than only the current
        prompt's prefill; the boundary decay keeps old requests from
        permanently pinning the ranking when the workload mix drifts.
        """
        self.counts *= decay
        self.gate_mass *= decay

    def clone(self) -> "HotnessTracker":
        """Deep copy (counts + gate mass) for forked replay simulations."""
        import copy

        return copy.deepcopy(self)

    def hotness(self) -> np.ndarray:
        """[L, E] combined score: frequency + gate mass."""
        c = self.counts / max(self.counts.max(), 1e-9)
        g = self.gate_mass / max(self.gate_mass.max(), 1e-9)
        return 0.5 * c + 0.5 * g


def pcw_reshape(cache: SliceCache, store: ExpertSliceStore,
                tracker: HotnessTracker, *,
                lsb_keep_frac: float = 0.125,
                msb_keep_frac: float = 1.0) -> dict:
    """Apply the PCW transition reshape.  Returns an action summary."""
    hot = tracker.hotness()
    L, E = hot.shape

    flat = hot.reshape(-1)
    lsb_thresh = float(np.quantile(flat, 1.0 - lsb_keep_frac)) \
        if lsb_keep_frac < 1.0 else -1.0
    msb_thresh = float(np.quantile(flat, 1.0 - msb_keep_frac)) \
        if msb_keep_frac < 1.0 else -1.0

    # 1) drop cold LSBs, 2) drop cold MSBs.
    evicted_lsb = cache.evict_where(
        lambda k: k.kind == "lsb" and hot[k.layer, k.expert] < lsb_thresh)
    evicted_msb = cache.evict_where(
        lambda k: k.kind == "msb" and hot[k.layer, k.expert] < msb_thresh)

    # 3) fill freed space with the hottest missing MSB slices (these bytes
    # were already streamed through DRAM during prefill; reshaping keeps
    # them instead of dropping them — no extra Flash traffic is charged).
    # Every MSB slice is the same size, so the first one that doesn't fit
    # marks its shard full; the scan ends once every shard is full (for
    # the single-device cache that is the first non-fit, as before).
    order = np.argsort(-flat)
    installed = 0
    nb = store.msb_bytes_per_expert
    full_shards: set = set()
    for idx in order:
        if len(full_shards) >= cache.n_shards:
            break
        lidx, e = divmod(int(idx), E)
        key = SliceKey(lidx, e, "msb")
        sid = cache.shard_index(key)
        if sid in full_shards:
            continue
        if not cache.can_fit(key, nb):
            full_shards.add(sid)
            continue
        if key in cache:
            continue
        cache.insert(key, nb)
        installed += 1

    # 4) hotness-aligned recency over the FULL final population —
    # survivors and installs together.  Re-ranking must run *after* the
    # install loop: inserting into an already-reordered cache appended
    # every installed slice at the recency tail, so installs (added
    # hottest-first, hottest nearest the LRU head) outranked every
    # survivor regardless of hotness.
    ranking: Dict[SliceKey, float] = {
        k: float(hot[k.layer, k.expert]) for k in cache.resident_keys()}
    cache.reorder_by(ranking)

    return {
        "evicted_lsb": len(evicted_lsb),
        "evicted_msb": len(evicted_msb),
        "installed_msb": installed,
        "resident": len(cache),
    }


# --------------------------------------------------------------------------
# Baseline initial states (paper Fig. 10)
# --------------------------------------------------------------------------
def init_empty(cache: SliceCache, *_args, **_kw) -> None:
    cache.clear()


def init_last_layer(cache: SliceCache, store: ExpertSliceStore,
                    *_args, **_kw) -> None:
    """Keep only the last prefill layer's experts (naive leftover state)."""
    cache.clear()
    last = max(store.layers.keys())
    for e in range(store.n_experts):
        for kind in ("msb", "lsb"):
            key = SliceKey(last, e, kind)
            nb = store.slice_bytes(key)
            if cache.can_fit(key, nb):
                cache.insert(key, nb)


def init_random(cache: SliceCache, store: ExpertSliceStore, *,
                seed: int = 0, **_kw) -> None:
    cache.clear()
    rng = np.random.default_rng(seed)
    keys = list(store.all_keys())
    rng.shuffle(keys)
    for key in keys:
        nb = store.slice_bytes(key)
        if not cache.can_fit(key, nb):
            if cache.n_shards == 1:
                break
            continue
        cache.insert(key, nb)


INIT_STATES = {
    "empty": init_empty,
    "last_layer": init_last_layer,
    "random": init_random,
}
