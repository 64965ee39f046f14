"""Slice-granular DRAM cache simulator (paper §4.1, §6.1-3).

A copy of ``repro.core.cache`` for the port (pure Python, no torch).


Deterministic model of the DRAM expert cache sitting between Flash and the
XPU.  Keys are :class:`~repro_torch.core.slices.SliceKey`; capacity is in bytes.

Policy (DBSC heterogeneous management):
  * **MSB slices** — standard LRU.
  * **LSB slices** — lowest priority: they live in a separate segment that
    is evicted *before* any MSB slice is touched ("aggressively evicted
    after initial access").

Setting ``slice_aware=False`` collapses both segments into one LRU — the
paper's baseline cache (used with whole-expert keys for high-bit /
uniform-low-bit baselines).

Every miss/hit is charged to a :class:`~repro_torch.hw.energy.CostLedger` by the
caller (the engine), keeping the cache purely a state machine.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.core.slices import SliceKey


class SliceTooLargeError(ValueError):
    """A slice bigger than the whole cache was offered for insertion.

    Raised by :meth:`SliceCache.insert` so the caller can't confuse
    "dropped" with "already resident" (both used to return ``[]``):
    a dropped fill never lands in DRAM, so the ledger must charge a
    direct Flash→XPU stream instead of a fill + DRAM read.
    """

    def __init__(self, key: SliceKey, nbytes: float, capacity: float):
        super().__init__(
            f"slice {key} ({nbytes:.0f} B) exceeds cache capacity "
            f"({capacity:.0f} B); fill dropped")
        self.key = key
        self.nbytes = nbytes
        self.capacity = capacity


@dataclasses.dataclass
class CacheStats:
    msb_hits: int = 0
    msb_misses: int = 0
    lsb_hits: int = 0
    lsb_misses: int = 0
    n_dropped: int = 0     # fills dropped because the slice outsizes the cache

    def record(self, kind: str, hit: bool) -> None:
        f = f"{kind}_{'hits' if hit else 'misses'}"
        setattr(self, f, getattr(self, f) + 1)

    @property
    def accesses(self) -> int:
        return self.msb_hits + self.msb_misses + self.lsb_hits + self.lsb_misses

    @property
    def misses(self) -> int:
        return self.msb_misses + self.lsb_misses

    @property
    def miss_rate(self) -> float:
        return self.misses / max(self.accesses, 1)

    @property
    def msb_miss_rate(self) -> float:
        return self.msb_misses / max(self.msb_hits + self.msb_misses, 1)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.msb_hits = self.msb_misses = 0
        self.lsb_hits = self.lsb_misses = 0
        self.n_dropped = 0


class SliceCache:
    """Byte-capacity cache with the DBSC two-segment policy."""

    # Single-device cache: one shard holding every expert.  The
    # expert-parallel wrapper (repro.core.shard.ShardedSliceCache)
    # overrides these so shard-agnostic callers (PCW reshape, the init
    # states) can ask "does this slice's *owning* shard have room"
    # without knowing whether the cache is partitioned.
    n_shards: int = 1

    def shard_index(self, key: SliceKey) -> int:
        return 0

    def can_fit(self, key: SliceKey, nbytes: float) -> bool:
        """Whether ``key`` fits in its owning shard without eviction."""
        return self.used + nbytes <= self.capacity

    def set_active_tenant(self, tenant) -> None:
        """Tenant-attribution hint for fills.  No-op here: the flat cache
        has no per-tenant segments.  The engine calls this unconditionally
        on its charge path; :class:`repro_torch.control.partition.
        TenantPartitionedCache` overrides it to route fills."""

    def __init__(self, capacity_bytes: float, *, slice_aware: bool = True):
        self.capacity = float(capacity_bytes)
        self.slice_aware = slice_aware
        self._msb: "OrderedDict[SliceKey, float]" = OrderedDict()
        self._lsb: "OrderedDict[SliceKey, float]" = OrderedDict()
        self.used = 0.0
        self.stats = CacheStats()
        # In-flight fill state: completion time (timeline seconds) of a
        # resident entry whose Flash→DRAM transfer is still landing.  A
        # consumer arriving before ``ready_time`` must wait for it; an
        # entry with no record is fully landed (ready at any time).
        self._ready_at: Dict[SliceKey, float] = {}
        # Cross-request stats epochs: each served request gets its own
        # hit/miss window while cache *contents* persist, so a warm-vs-cold
        # miss-rate curve can be read off epoch-by-epoch.
        self.epochs: List[Tuple[str, dict]] = []
        self._epoch_label: Optional[str] = None

    # ------------------------------------------------------------- epochs
    def begin_epoch(self, label: str) -> None:
        """Archive the current stats window under its label, start a new one.

        Contents (and therefore warmth) are untouched — only the counters
        roll over.  Used by the persistent engine at request boundaries.
        """
        self.end_epoch()
        self._epoch_label = label
        self.stats = CacheStats()

    def end_epoch(self) -> None:
        """Archive the open epoch (no-op when none is open)."""
        if self._epoch_label is None:
            return
        self.epochs.append((self._epoch_label, self.stats.snapshot()))
        self._epoch_label = None
        self.stats = CacheStats()

    def epoch_miss_rates(self) -> List[Tuple[str, float]]:
        """[(label, miss_rate)] over archived epochs — the warm-up curve."""
        return [(label, CacheStats(**snap).miss_rate)
                for label, snap in self.epochs]

    def epoch_counts(self) -> List[Tuple[str, int, int]]:
        """[(label, accesses, misses)] over archived epochs.

        The raw integer counts behind :meth:`epoch_miss_rates` — what the
        trace-replay fidelity gate compares exactly (rates alone can
        agree by coincidence while the underlying counts differ).
        """
        return [(label, CacheStats(**snap).accesses,
                 CacheStats(**snap).misses)
                for label, snap in self.epochs]

    def usage(self) -> dict:
        """Point-in-time occupancy plus *lifetime* access counts.

        ``stats`` resets at every epoch boundary (request boundaries
        under persistent serving), so a monotonic consumer — the
        metrics registry (``repro_torch.obs.metrics``) — must read the
        archived epochs folded back in, not the open window alone.
        """
        acc = self.stats.accesses
        miss = self.stats.misses
        for _, snap in self.epochs:
            st = CacheStats(**snap)
            acc += st.accesses
            miss += st.misses
        return {
            "capacity_bytes": self.capacity,
            "used_bytes": self.used,
            "n_slices": len(self),
            "occupancy": self.used / self.capacity if self.capacity
            else 0.0,
            "accesses": acc,
            "misses": miss,
        }

    def clone(self) -> "SliceCache":
        """Deep copy of the full cache state (contents, recency order,
        stats windows, in-flight fills).  Used by the replay simulator to
        fork a simulation mid-trace without disturbing the original."""
        import copy

        return copy.deepcopy(self)

    # ----------------------------------------------------------- internals
    def _segment(self, key: SliceKey) -> "OrderedDict[SliceKey, float]":
        if not self.slice_aware:
            return self._msb
        return self._lsb if key.kind == "lsb" else self._msb

    def _evict_one(self) -> Optional[Tuple[SliceKey, float]]:
        """Evict the lowest-priority entry: LSB segment first, then MSB LRU."""
        if self._lsb:
            key, nb = self._lsb.popitem(last=False)
        elif self._msb:
            key, nb = self._msb.popitem(last=False)
        else:
            return None
        self.used -= nb
        self._ready_at.pop(key, None)
        return key, nb

    def _make_room(self, nbytes: float) -> List[SliceKey]:
        evicted = []
        while self.used + nbytes > self.capacity:
            e = self._evict_one()
            if e is None:
                break
            evicted.append(e[0])
        return evicted

    # ----------------------------------------------------------------- api
    def __contains__(self, key: SliceKey) -> bool:
        return key in self._msb or key in self._lsb

    def __len__(self) -> int:
        return len(self._msb) + len(self._lsb)

    def contains(self, key: SliceKey) -> bool:
        return key in self

    def access(self, key: SliceKey, nbytes: float,
               *, fill_on_miss: bool = True) -> bool:
        """Touch ``key``; returns True on hit.  Fills (with eviction) on miss.

        An oversized fill (``nbytes > capacity``) is *dropped*, counted in
        ``stats.n_dropped``, and the miss is reported as usual — callers
        that need to distinguish a landed fill from a drop check
        ``key in cache`` after a missed access (see the engine's charge
        path) or call :meth:`insert` directly and catch
        :class:`SliceTooLargeError`.
        """
        seg = self._segment(key)
        hit = key in seg
        self.stats.record(key.kind, hit)
        if hit:
            if key.kind == "msb" or not self.slice_aware:
                seg.move_to_end(key)      # LRU bump; LSBs stay low priority
            return True
        if fill_on_miss:
            try:
                self.insert(key, nbytes)
            except SliceTooLargeError:
                self.stats.n_dropped += 1
        return False

    def insert(self, key: SliceKey, nbytes: float) -> List[SliceKey]:
        """Install ``key``, evicting low-priority entries to make room.

        Returns the evicted keys.  Raises :class:`SliceTooLargeError`
        when the slice cannot fit even in an empty cache — previously
        this silently returned ``[]``, indistinguishable from "already
        resident", so callers charged the ledger for fills that never
        happened.
        """
        if nbytes > self.capacity:
            raise SliceTooLargeError(key, nbytes, self.capacity)
        seg = self._segment(key)
        if key in seg:
            seg.move_to_end(key)
            return []
        evicted = self._make_room(nbytes)
        seg[key] = nbytes
        self.used += nbytes
        return evicted

    # --------------------------------------------------- in-flight fills
    def mark_inflight(self, key: SliceKey, ready_t: float) -> None:
        """Record that ``key``'s fill (already inserted) lands at
        ``ready_t`` on the simulation timeline.  Used by the async decode
        replay so a consumer arriving earlier stalls until the transfer
        completes instead of re-issuing it."""
        if key in self:
            self._ready_at[key] = ready_t

    def ready_time(self, key: SliceKey, default: float = 0.0) -> float:
        """Timeline second at which ``key`` is usable (``default`` when
        no fill is in flight for it)."""
        return self._ready_at.get(key, default)

    def settle(self, now: float) -> None:
        """Forget in-flight records that have landed by ``now``."""
        self._ready_at = {k: t for k, t in self._ready_at.items()
                          if t > now}

    def nbytes_of(self, key: SliceKey, default: float = 0.0) -> float:
        """Resident size of ``key`` (``default`` when not resident).
        Used by placement migration to move slices at their true size."""
        for seg in (self._msb, self._lsb):
            if key in seg:
                return seg[key]
        return default

    def evict(self, key: SliceKey) -> bool:
        for seg in (self._msb, self._lsb):
            if key in seg:
                self.used -= seg.pop(key)
                self._ready_at.pop(key, None)
                return True
        return False

    def resident_keys(self) -> List[SliceKey]:
        return list(self._msb.keys()) + list(self._lsb.keys())

    def residency(self, n_layers: int, n_experts: int):
        """Dense bool arrays (msb[L,E], lsb[L,E]) for jit-input masks."""
        import numpy as np

        msb = np.zeros((n_layers, n_experts), bool)
        lsb = np.zeros((n_layers, n_experts), bool)
        for k in self._msb:
            if k.kind == "msb":
                msb[k.layer, k.expert] = True
            else:  # slice_aware=False stores everything in _msb
                lsb[k.layer, k.expert] = True
        for k in self._lsb:
            lsb[k.layer, k.expert] = True
        return msb, lsb

    # ------------------------------------------------------- PCW interface
    def reorder_by(self, ranking: Dict[SliceKey, float]) -> None:
        """Rebuild recency so higher-ranked keys are evicted last."""
        for seg in (self._msb, self._lsb):
            items = sorted(seg.items(), key=lambda kv: ranking.get(kv[0], 0.0))
            seg.clear()
            for k, v in items:
                seg[k] = v

    def evict_where(self, pred) -> List[SliceKey]:
        out = []
        for seg in (self._msb, self._lsb):
            for k in [k for k in seg if pred(k)]:
                self.used -= seg.pop(k)
                self._ready_at.pop(k, None)
                out.append(k)
        return out

    def clear(self) -> None:
        self._msb.clear()
        self._lsb.clear()
        self._ready_at.clear()
        self.used = 0.0
