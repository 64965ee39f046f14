"""Per-tenant byte-budget partitioning of the slice cache.

A copy of ``repro.control.partition`` for the port (numpy only, no torch).

:class:`TenantPartitionedCache` splits one DRAM budget into per-tenant
segments plus a shared segment, behind the exact
:class:`~repro_torch.core.cache.SliceCache` surface the engine's charge path,
PCW reshape and the init states consume (the same composition move as
:class:`~repro_torch.core.shard.ShardedSliceCache`, but along the *tenant*
axis instead of the expert-placement axis, and with **resizable**
budgets — the controller's partition actuator calls
:meth:`set_budgets`).

Semantics:

* **Lookup is shared.**  An access hits if the slice is resident in
  *any* segment — tenants routing to the same hot expert share one
  copy; partitioning controls eviction pressure, not visibility.
* **Eviction is isolated.**  A fill lands in the *active tenant's*
  segment (set by the engine via :meth:`set_active_tenant` before each
  expert's accesses) and can only evict within that segment.  A noisy
  tenant's miss storm therefore cannot evict a quiet tenant's working
  set — the isolation property the controller's partition actuator
  relies on.
* **Unattributed fills go to the shared segment**: prefetch inserts,
  warmup installs for unknown tenants, and any access with no active
  tenant set.

Hit/miss stats and epochs live on the wrapper (an access is one event
regardless of which segment holds the slice); segment-level counters
stay zero by construction, and :meth:`segment_summary` reports byte
occupancy instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.cache import CacheStats, SliceCache, SliceTooLargeError
from repro_torch.core.slices import SliceKey

__all__ = ["SHARED_SEGMENT", "TenantPartitionedCache"]

SHARED_SEGMENT = "shared"


class TenantPartitionedCache:
    """Per-tenant :class:`SliceCache` segments behind one cache surface."""

    n_shards: int = 1

    def shard_index(self, key: SliceKey) -> int:
        return 0

    def __init__(self, capacity_bytes: float, tenants: Iterable[str], *,
                 shared_frac: float = 0.25, slice_aware: bool = True):
        names = sorted(set(tenants))
        if not names:
            raise ValueError("TenantPartitionedCache needs >= 1 tenant")
        if SHARED_SEGMENT in names:
            raise ValueError(
                f"tenant name {SHARED_SEGMENT!r} is reserved")
        if not 0.0 <= shared_frac < 1.0:
            raise ValueError(f"shared_frac must be in [0, 1), "
                             f"got {shared_frac}")
        self.slice_aware = slice_aware
        total = float(capacity_bytes)
        shared_bytes = shared_frac * total
        per_tenant = (total - shared_bytes) / len(names)
        self.segments: Dict[str, SliceCache] = {
            t: SliceCache(per_tenant, slice_aware=slice_aware)
            for t in names}
        self.segments[SHARED_SEGMENT] = SliceCache(
            shared_bytes, slice_aware=slice_aware)
        self.tenants = names
        self._active: Optional[str] = None
        self.stats = CacheStats()
        self.epochs: List[Tuple[str, dict]] = []
        self._epoch_label: Optional[str] = None

    # ------------------------------------------------------------ routing
    def set_active_tenant(self, tenant: Optional[str]) -> None:
        """Sticky fill-routing hint: subsequent miss fills land in this
        tenant's segment (unknown / ``None`` -> shared)."""
        self._active = tenant

    def _fill_segment(self) -> SliceCache:
        return self.segments.get(self._active or SHARED_SEGMENT,
                                 self.segments[SHARED_SEGMENT])

    def _find(self, key: SliceKey) -> Optional[SliceCache]:
        """Owning segment of a resident key, deterministic scan order."""
        for name in self.tenants:
            if key in self.segments[name]:
                return self.segments[name]
        if key in self.segments[SHARED_SEGMENT]:
            return self.segments[SHARED_SEGMENT]
        return None

    # ----------------------------------------------------- aggregate state
    @property
    def capacity(self) -> float:
        return sum(s.capacity for s in self.segments.values())

    @property
    def used(self) -> float:
        return sum(s.used for s in self.segments.values())

    def __contains__(self, key: SliceKey) -> bool:
        return self._find(key) is not None

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments.values())

    def contains(self, key: SliceKey) -> bool:
        return key in self

    def can_fit(self, key: SliceKey, nbytes: float) -> bool:
        s = self._fill_segment()
        return s.used + nbytes <= s.capacity

    def fill_capacity(self) -> float:
        """Capacity of the segment a miss fill would land in right now —
        the engine's dropped-fill check (a slice bigger than the target
        segment streams Flash->XPU instead of filling DRAM)."""
        return self._fill_segment().capacity

    # ------------------------------------------------------------- mutate
    def access(self, key: SliceKey, nbytes: float,
               *, fill_on_miss: bool = True) -> bool:
        seg = self._find(key)
        hit = seg is not None
        self.stats.record(key.kind, hit)
        if hit:
            if key.kind == "msb" or not self.slice_aware:
                seg._segment(key).move_to_end(key)
            return True
        if fill_on_miss:
            try:
                self.insert(key, nbytes)
            except SliceTooLargeError:
                self.stats.n_dropped += 1
        return False

    def insert(self, key: SliceKey, nbytes: float) -> List[SliceKey]:
        seg = self._find(key)
        if seg is not None:
            seg._segment(key).move_to_end(key)
            return []
        return self._fill_segment().insert(key, nbytes)

    def evict(self, key: SliceKey) -> bool:
        seg = self._find(key)
        return seg.evict(key) if seg is not None else False

    def evict_where(self, pred) -> List[SliceKey]:
        out: List[SliceKey] = []
        for s in self.segments.values():
            out.extend(s.evict_where(pred))
        return out

    def reorder_by(self, ranking) -> None:
        for s in self.segments.values():
            s.reorder_by(ranking)

    def clear(self) -> None:
        for s in self.segments.values():
            s.clear()

    # ---------------------------------------------------- budget actuator
    def budgets(self) -> Dict[str, float]:
        """Current per-segment capacities (tenants + shared)."""
        return {name: s.capacity for name, s in self.segments.items()}

    def set_budgets(self, budgets: Dict[str, float]) -> List[SliceKey]:
        """Resize segment capacities; evict LRU overflow from any
        segment that shrank below its occupancy.  Returns evicted keys.

        Partial dicts are fine — unnamed segments keep their budget.
        The controller is responsible for conserving the total; this
        method only enforces per-segment occupancy <= capacity.
        """
        evicted: List[SliceKey] = []
        for name, cap in budgets.items():
            if name not in self.segments:
                raise KeyError(f"unknown cache segment {name!r}")
            if cap < 0:
                raise ValueError(f"negative budget for {name!r}: {cap}")
            seg = self.segments[name]
            seg.capacity = float(cap)
            while seg.used > seg.capacity:
                e = seg._evict_one()
                if e is None:
                    break
                evicted.append(e[0])
        return evicted

    # --------------------------------------------------- in-flight fills
    def mark_inflight(self, key: SliceKey, ready_t: float) -> None:
        seg = self._find(key)
        if seg is not None:
            seg.mark_inflight(key, ready_t)

    def ready_time(self, key: SliceKey, default: float = 0.0) -> float:
        seg = self._find(key)
        return seg.ready_time(key, default) if seg is not None else default

    def settle(self, now: float) -> None:
        for s in self.segments.values():
            s.settle(now)

    # ------------------------------------------------------------- reads
    def resident_keys(self) -> List[SliceKey]:
        out: List[SliceKey] = []
        for name in self.tenants:
            out.extend(self.segments[name].resident_keys())
        out.extend(self.segments[SHARED_SEGMENT].resident_keys())
        return out

    def residency(self, n_layers: int, n_experts: int):
        import numpy as np

        msb = np.zeros((n_layers, n_experts), bool)
        lsb = np.zeros((n_layers, n_experts), bool)
        for s in self.segments.values():
            m, l = s.residency(n_layers, n_experts)
            msb |= m
            lsb |= l
        return msb, lsb

    def segment_summary(self) -> Dict[str, dict]:
        """Byte occupancy per segment (stats live on the wrapper)."""
        return {name: {"capacity_bytes": s.capacity,
                       "used_bytes": s.used, "n_slices": len(s)}
                for name, s in self.segments.items()}

    # ------------------------------------------------------------- epochs
    # The wrapper owns the hit/miss counters (an access is one event no
    # matter which segment holds the slice), so epochs roll over here —
    # same shape as SliceCache's, which the fidelity gate compares.
    def begin_epoch(self, label: str) -> None:
        self.end_epoch()
        self._epoch_label = label
        self.stats = CacheStats()

    def end_epoch(self) -> None:
        if self._epoch_label is None:
            return
        self.epochs.append((self._epoch_label, self.stats.snapshot()))
        self._epoch_label = None
        self.stats = CacheStats()

    def epoch_miss_rates(self) -> List[Tuple[str, float]]:
        return [(label, CacheStats(**snap).miss_rate)
                for label, snap in self.epochs]

    def epoch_counts(self) -> List[Tuple[str, int, int]]:
        return [(label, CacheStats(**snap).accesses,
                 CacheStats(**snap).misses)
                for label, snap in self.epochs]

    def usage(self) -> dict:
        """Occupancy + lifetime counts, same shape as
        :meth:`SliceCache.usage` (the metrics-registry view)."""
        return SliceCache.usage(self)

    def clone(self) -> "TenantPartitionedCache":
        import copy

        return copy.deepcopy(self)
