"""Expert-parallel sharding: placement + the per-shard slice cache set.

A copy of ``repro.core.shard`` for the port (numpy only, no torch).

Expert parallelism partitions the experts of every MoE layer across
``ep`` shards along the mesh ``model`` axis; each shard owns the DRAM
slice cache (and, in :mod:`repro_torch.hw.energy`, the Flash/DRAM channel
clocks) for its experts.  Ownership is decided by a
:class:`~repro_torch.core.placement.PlacementMap` — an explicit ``[L, E] →
shard`` table (plus a replication mask) chosen by a placement policy:

* ``round_robin`` reproduces the original pure-modulo ``expert % ep``
  bit-identically (and is what the legacy :func:`shard_of_expert`
  helper still computes for placement-agnostic callers);
* ``hotness`` re-packs hotness-ranked experts onto shards for balance,
  with migrations applied through :meth:`ShardedSliceCache.
  apply_placement`;
* ``hotness+replicate:k`` additionally keeps the k hottest experts
  resident on every shard so dispatch resolves locally.

A routing trace recorded on a single device still replays under *any*
``ep_shards`` and *any* placement (the trace stores expert ids, never
device ids), which is what makes both EP and placement sweepable axes
in :mod:`repro_torch.sim.autotune`; the live engine, the replay simulator and
the telemetry all agree on ownership because placement decisions are
pure functions of charge-path hotness.

:class:`ShardedSliceCache` wraps ``ep`` independent
:class:`~repro_torch.core.cache.SliceCache` instances (each holding
``capacity_bytes / ep`` — the aggregate DRAM budget is *iso* with the
single-device run, split in proportion to each shard's expert
population) behind the exact :class:`SliceCache` surface the engine's
charge path, PCW reshape and the policy-state builder consume.  Routing
is by key; stats/epochs aggregate across shards on read while the
per-shard windows stay addressable for the EP fidelity gate and the
serving telemetry breakdown.

Tokens also have a home shard (the dense, non-expert half of the model
runs data-parallel over the same devices): decode slot ``b`` and
prefill position ``t`` live on shard ``b % ep`` / ``t % ep``.  A
selection whose expert lives elsewhere pays all-to-all dispatch bytes —
charged by the engine on the interconnect channel, computed here by
:func:`all_to_all_bytes`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.cache import CacheStats, SliceCache
from repro_torch.core.placement import PlacementMap
from repro_torch.core.slices import SliceKey

__all__ = ["shard_of_expert", "expert_placement", "home_shard_of_token",
           "remote_selection_mask", "all_to_all_bytes",
           "ShardedSliceCache"]


def shard_of_expert(expert, n_shards: int):
    """Owning shard of ``expert``: round-robin, pure in the expert id.

    Accepts a scalar (returns int) or an id ndarray (returns the
    elementwise placement) — every ownership decision in the engine,
    replay and telemetry goes through this one function.
    """
    if isinstance(expert, np.ndarray):
        return expert % int(n_shards)
    return int(expert) % int(n_shards)


def expert_placement(n_experts: int, n_shards: int) -> np.ndarray:
    """[E] int array mapping every expert id to its owning shard."""
    return shard_of_expert(np.arange(n_experts, dtype=np.int64), n_shards)


def home_shard_of_token(token_idx, n_shards: int):
    """Home shard of a decode slot / prompt position: the dense
    (non-expert) half of the model runs data-parallel round-robin over
    the same shards.  Scalar or ndarray, like :func:`shard_of_expert`."""
    return shard_of_expert(token_idx, n_shards)


def remote_selection_mask(token_idx: np.ndarray, expert_ids: np.ndarray,
                          n_shards: int, *,
                          owner_row: Optional[np.ndarray] = None,
                          replicated_row: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Bool mask over flat parallel (token, expert) selections: True
    where the token's home shard (``token_idx % n_shards``) differs
    from the expert's owner, i.e. the selection pays all-to-all.

    ``owner_row`` (an ``[E]`` shard table, one placement-map layer row)
    replaces the legacy modulo owner when given; selections of experts
    marked in ``replicated_row`` are never remote — the token's home
    shard holds its own replica, so dispatch resolves locally.
    """
    if n_shards <= 1 or token_idx.size == 0:
        return np.zeros(token_idx.shape, bool)
    if owner_row is None:
        owner = shard_of_expert(expert_ids, n_shards)
    else:
        owner = np.asarray(owner_row)[expert_ids]
    remote = home_shard_of_token(token_idx, n_shards) != owner
    if replicated_row is not None:
        remote &= ~np.asarray(replicated_row, bool)[expert_ids]
    return remote


def all_to_all_bytes(token_idx: np.ndarray, expert_ids: np.ndarray,
                     d_model: int, n_shards: int,
                     itemsize: float = 1.0, *,
                     owner_row: Optional[np.ndarray] = None,
                     replicated_row: Optional[np.ndarray] = None) -> float:
    """Dispatch + combine bytes for one layer's routed selections.

    ``token_idx``/``expert_ids``: flat parallel arrays, one entry per
    *active* (token, slot) selection.  Each remote selection (see
    :func:`remote_selection_mask`) moves its ``d_model`` activation to
    the expert's shard and the result back (2x).  Activations travel at
    ``itemsize`` bytes/element (int8 by default, matching the engine's
    INT8 non-expert traffic convention).  ``owner_row`` /
    ``replicated_row`` carry the placement map's layer row through to
    the remoteness test.
    """
    remote = remote_selection_mask(token_idx, expert_ids, n_shards,
                                   owner_row=owner_row,
                                   replicated_row=replicated_row)
    return 2.0 * d_model * itemsize * float(np.count_nonzero(remote))


class _AggregateStats:
    """Read/reset view over the per-shard :class:`CacheStats` windows.

    Mirrors the pieces of ``CacheStats`` the engine, scheduler and
    benchmarks touch on ``cache.stats`` (snapshot / reset / the derived
    counters); mutation happens inside each shard's own ``access``.
    """

    def __init__(self, shards: List[SliceCache]):
        self._shards = shards

    def combined(self) -> CacheStats:
        """One summed :class:`CacheStats` over the shards.

        Callers reading several counters should grab this once per read
        batch instead of touching attributes on the aggregate view —
        each attribute read re-sums (the old path additionally built a
        full snapshot dict *per attribute*, an O(shards) dict merge for
        every counter; this sums the five raw fields directly).
        """
        c = CacheStats()
        for sh in self._shards:
            st = sh.stats
            c.msb_hits += st.msb_hits
            c.msb_misses += st.msb_misses
            c.lsb_hits += st.lsb_hits
            c.lsb_misses += st.lsb_misses
            c.n_dropped += st.n_dropped
        return c

    def snapshot(self) -> dict:
        return self.combined().snapshot()

    def reset(self) -> None:
        for s in self._shards:
            s.stats.reset()

    def __getattr__(self, name):
        # Derived counters (accesses, misses, miss_rate, msb_misses, ...)
        # resolve against one combined CacheStats.
        return getattr(self.combined(), name)


class ShardedSliceCache:
    """``ep`` per-shard :class:`SliceCache` instances behind one surface.

    Every key-addressed operation routes to the owning shard — decided
    by the :class:`~repro_torch.core.placement.PlacementMap` when one is set,
    or the legacy round-robin modulo otherwise (direct constructions in
    tests and the modulo path are bit-identical to ``round_robin``
    placement by design).  Aggregate reads (``used``, ``residency``,
    ``stats``, ``epochs``) combine shards.  Capacity is split evenly:
    each shard holds ``capacity_bytes / n_shards``, so LRU/eviction
    pressure is strictly shard-local — exactly the deployment question
    EP poses (a hot shard cannot borrow a cold shard's DRAM).  Replicas
    of experts marked in the placement map live in *other* shards'
    segments too, inserted there by the engine's replica dispatch and
    charged against those shards' budgets; key-routed operations here
    always address the owner's copy.
    """

    def __init__(self, capacity_bytes: float, n_shards: int, *,
                 slice_aware: bool = True,
                 placement: Optional[PlacementMap] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if placement is not None and placement.n_shards != int(n_shards):
            raise ValueError(
                f"placement map is for {placement.n_shards} shards, "
                f"cache has {n_shards}")
        self.n_shards = int(n_shards)
        self.slice_aware = slice_aware
        self.placement = placement
        self.shards: List[SliceCache] = [
            SliceCache(capacity_bytes / self.n_shards,
                       slice_aware=slice_aware)
            for _ in range(self.n_shards)]

    # ------------------------------------------------------------ routing
    def shard_index(self, key: SliceKey) -> int:
        if self.placement is not None:
            return self.placement.owner_of(key.layer, key.expert)
        return shard_of_expert(key.expert, self.n_shards)

    def shard(self, key: SliceKey) -> SliceCache:
        return self.shards[self.shard_index(key)]

    # ----------------------------------------------------- aggregate state
    @property
    def capacity(self) -> float:
        return sum(s.capacity for s in self.shards)

    @property
    def used(self) -> float:
        return sum(s.used for s in self.shards)

    @property
    def stats(self) -> _AggregateStats:
        return _AggregateStats(self.shards)

    def __contains__(self, key: SliceKey) -> bool:
        if (self.placement is not None
                and self.placement.is_replicated(key.layer, key.expert)):
            return any(key in s for s in self.shards)
        return key in self.shard(key)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def contains(self, key: SliceKey) -> bool:
        return key in self

    def can_fit(self, key: SliceKey, nbytes: float) -> bool:
        s = self.shard(key)
        return s.used + nbytes <= s.capacity

    def set_active_tenant(self, tenant) -> None:
        """No-op (see :meth:`SliceCache.set_active_tenant`)."""

    # ------------------------------------------------------------- mutate
    def access(self, key: SliceKey, nbytes: float,
               *, fill_on_miss: bool = True) -> bool:
        return self.shard(key).access(key, nbytes,
                                      fill_on_miss=fill_on_miss)

    def insert(self, key: SliceKey, nbytes: float) -> List[SliceKey]:
        return self.shard(key).insert(key, nbytes)

    def evict(self, key: SliceKey) -> bool:
        return self.shard(key).evict(key)

    def evict_where(self, pred) -> List[SliceKey]:
        out: List[SliceKey] = []
        for s in self.shards:
            out.extend(s.evict_where(pred))
        return out

    def reorder_by(self, ranking) -> None:
        for s in self.shards:
            s.reorder_by(ranking)

    def clear(self) -> None:
        for s in self.shards:
            s.clear()

    # ---------------------------------------------------------- migration
    def apply_placement(self, new_map: PlacementMap
                        ) -> List[Tuple[SliceKey, float, int, int]]:
        """Adopt ``new_map``, physically moving displaced resident slices.

        A resident slice stays put if its shard is still the owner under
        the new map, or if the slice is replicated (replicas are valid
        on any shard).  Everything else is evicted from its old shard
        and inserted into the new owner (which may LRU-evict locally to
        make room — honest capacity pressure on the receiving side).

        Returns the executed moves ``[(key, nbytes, from, to)]`` in a
        deterministic (layer, expert, kind, source-shard) order; the
        caller (the engine) charges ``sum(nbytes)`` on the interconnect
        channel.  A slice whose new owner already holds a copy is simply
        freed — no bytes cross the interconnect for it.
        """
        plan: List[Tuple[int, int, str, int, SliceKey]] = []
        for sid, sh in enumerate(self.shards):
            for key in sh.resident_keys():
                keep = (sid == new_map.owner_of(key.layer, key.expert)
                        or new_map.is_replicated(key.layer, key.expert))
                if not keep:
                    plan.append((key.layer, key.expert, key.kind, sid, key))
        plan.sort(key=lambda t: t[:4])
        moves: List[Tuple[SliceKey, float, int, int]] = []
        for lidx, e, _kind, sid, key in plan:
            src = self.shards[sid]
            if key not in src:      # displaced by an earlier move's insert
                continue
            nb = src.nbytes_of(key)
            ready = src.ready_time(key, 0.0)
            src.evict(key)
            dst_sid = new_map.owner_of(lidx, e)
            dst = self.shards[dst_sid]
            if key in dst or nb > dst.capacity:
                continue            # freed (copy exists) or unfittable
            dst.insert(key, nb)
            if ready > 0.0:
                dst.mark_inflight(key, ready)
            moves.append((key, nb, sid, dst_sid))
        self.placement = new_map
        return moves

    # --------------------------------------------------- in-flight fills
    def mark_inflight(self, key: SliceKey, ready_t: float) -> None:
        self.shard(key).mark_inflight(key, ready_t)

    def ready_time(self, key: SliceKey, default: float = 0.0) -> float:
        return self.shard(key).ready_time(key, default)

    def settle(self, now: float) -> None:
        for s in self.shards:
            s.settle(now)

    # ------------------------------------------------------------- reads
    def resident_keys(self) -> List[SliceKey]:
        out: List[SliceKey] = []
        for s in self.shards:
            out.extend(s.resident_keys())
        return out

    def residency(self, n_layers: int, n_experts: int):
        msb = np.zeros((n_layers, n_experts), bool)
        lsb = np.zeros((n_layers, n_experts), bool)
        for s in self.shards:
            m, l = s.residency(n_layers, n_experts)
            msb |= m
            lsb |= l
        return msb, lsb

    # ------------------------------------------------------------- epochs
    # begin/end fan out so every shard's counter window rolls over at the
    # same request boundary; per-label aggregation sums the windows.
    def begin_epoch(self, label: str) -> None:
        for s in self.shards:
            s.begin_epoch(label)

    def end_epoch(self) -> None:
        for s in self.shards:
            s.end_epoch()

    @property
    def epochs(self) -> List[Tuple[str, dict]]:
        """Aggregated ``[(label, summed stats dict)]`` across shards."""
        if not self.shards[0].epochs:
            return []
        out: List[Tuple[str, dict]] = []
        for i, (label, snap) in enumerate(self.shards[0].epochs):
            agg = dict(snap)
            for s in self.shards[1:]:
                other_label, other = s.epochs[i]
                if other_label != label:
                    # Not an assert: those vanish under ``python -O``,
                    # and silently mis-summing epochs would corrupt the
                    # warm-up curve and the EP fidelity gate.
                    raise RuntimeError(
                        f"shard epoch skew: {other_label!r} != {label!r}")
                for k in agg:
                    agg[k] += other[k]
            out.append((label, agg))
        return out

    def epoch_miss_rates(self) -> List[Tuple[str, float]]:
        return [(label, CacheStats(**snap).miss_rate)
                for label, snap in self.epochs]

    def epoch_counts(self) -> List[Tuple[str, int, int]]:
        return [(label, CacheStats(**snap).accesses,
                 CacheStats(**snap).misses)
                for label, snap in self.epochs]

    def per_shard_epoch_counts(self) -> List[List[Tuple[str, int, int]]]:
        """Per-shard ``epoch_counts`` — the EP fidelity gate's unit."""
        return [s.epoch_counts() for s in self.shards]

    def per_shard_counts(self) -> List[Tuple[int, int]]:
        """Lifetime (accesses, misses) per shard: archived epochs plus
        the open window."""
        out = []
        for s in self.shards:
            acc = s.stats.accesses
            miss = s.stats.misses
            for _, snap in s.epochs:
                st = CacheStats(**snap)
                acc += st.accesses
                miss += st.misses
            out.append((acc, miss))
        return out

    def usage(self) -> dict:
        """Shard-summed occupancy + lifetime counts, same shape as
        :meth:`SliceCache.usage` (the metrics-registry view)."""
        rows = [s.usage() for s in self.shards]
        cap = sum(r["capacity_bytes"] for r in rows)
        used = sum(r["used_bytes"] for r in rows)
        return {
            "capacity_bytes": cap,
            "used_bytes": used,
            "n_slices": sum(r["n_slices"] for r in rows),
            "occupancy": used / cap if cap else 0.0,
            "accesses": sum(r["accesses"] for r in rows),
            "misses": sum(r["misses"] for r in rows),
        }

    def clone(self) -> "ShardedSliceCache":
        import copy

        return copy.deepcopy(self)
