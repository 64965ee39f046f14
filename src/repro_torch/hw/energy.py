"""Deterministic latency / energy accounting for the offload hierarchy
(port of ``repro.hw.energy``).

The cost model behind the paper's Figs. 9-10: every expert-slice transfer
(Flash→DRAM on a miss, DRAM→XPU on use) and every expert matmul is
charged against the active :class:`~repro_torch.hw.specs.SystemSpec`.
Each hardware channel (Flash, DRAM, XPU compute) carries its own
busy-until clock (:class:`ChannelTimeline`).  Two issue disciplines feed
the timeline:

* the serialized methods the sync charge path uses
  (:meth:`CostLedger.miss_fill`, :meth:`~CostLedger.flash_stream`,
  :meth:`~CostLedger.dram_read`, :meth:`~CostLedger.matmul`) issue every
  event at the global frontier, so the makespan is the sum of all
  durations (with ``overlap_io_compute``, IO waits only on the IO
  channels and compute only on the compute channel);
* the event methods the async charge path uses (:meth:`~CostLedger.fill_at`,
  :meth:`~CostLedger.dram_read_at`, :meth:`~CostLedger.matmul_at`,
  :meth:`~CostLedger.prefetch_fill_at`) take an explicit data-dependency
  time, so fills overlap compute and speculative fills ride a background
  Flash lane.

Energy is time-independent, so both disciplines charge the same energy
for the same events.  Expert parallelism is simulated in the charge path:
:class:`ShardedCostLedger` holds one :class:`CostLedger` per shard plus a
shared interconnect sub-ledger, whose channel carries the all-to-all
dispatch (:meth:`CostLedger.ici_transfer`) and the placement migrations
(:meth:`CostLedger.migrate`).  An attached
:class:`~repro_torch.obs.timeline.TimelineTracer` receives one event per
charge.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

from repro_torch.hw.specs import MOBILE_SOC, SystemSpec


def expert_weight_step_bytes(n_codes: float, n_groups: float, *,
                             quant_execution: bool,
                             dense_itemsize: int = 4) -> float:
    """Device-memory bytes one expert-FFN step moves for its weights
    (analytic).

    Codes are uint8 (1 B/element); group metadata is an f32 scale plus a
    uint8 zero-point (5 B/group), read by both paths.  Dense dequant
    additionally writes and re-reads the materialized dense tensor at
    ``dense_itemsize`` bytes/element; quantized execution streams only
    the packed codes.  A model of the traffic, not a measurement.
    """
    meta = n_groups * 5.0
    if quant_execution:
        return n_codes * 1.0 + meta
    return n_codes * (1.0 + 2.0 * dense_itemsize) + meta


@dataclasses.dataclass
class ChannelTimeline:
    """Busy-until clock for one hardware channel (FIFO issue)."""

    name: str
    busy_until: float = 0.0
    busy_s: float = 0.0

    def issue(self, t_ready: float, duration: float) -> Tuple[float, float]:
        start = max(t_ready, self.busy_until)
        end = start + duration
        self.busy_until = end
        self.busy_s += duration
        return start, end

    def reset(self) -> None:
        self.busy_until = 0.0
        self.busy_s = 0.0


@dataclasses.dataclass
class CostLedger:
    """Event-timeline latency + energy ledger over a simulated run."""

    system: SystemSpec = dataclasses.field(default_factory=lambda: MOBILE_SOC)
    # The serialized methods issue IO at the IO channels' frontier and
    # compute at the compute channel's, so a miss fill can overlap an
    # expert matmul; off, every serialized event waits on :attr:`now`.
    overlap_io_compute: bool = False

    # energy / traffic accumulators (time-independent)
    flash_bytes: float = 0.0
    dram_bytes: float = 0.0
    compute_ops: float = 0.0
    flash_latency_s: float = 0.0
    dram_latency_s: float = 0.0
    compute_latency_s: float = 0.0
    flash_energy_j: float = 0.0
    dram_energy_j: float = 0.0
    compute_energy_j: float = 0.0
    n_flash_transfers: int = 0
    n_dram_transfers: int = 0
    n_matmuls: int = 0

    # timeline state
    flash_ch: ChannelTimeline = dataclasses.field(
        default_factory=lambda: ChannelTimeline("flash"))
    dram_ch: ChannelTimeline = dataclasses.field(
        default_factory=lambda: ChannelTimeline("dram"))
    compute_ch: ChannelTimeline = dataclasses.field(
        default_factory=lambda: ChannelTimeline("compute"))
    # Background-priority Flash lane (see :meth:`prefetch_fill_at`):
    # speculative fills drain here so they never delay demand traffic.
    flash_bg_ch: ChannelTimeline = dataclasses.field(
        default_factory=lambda: ChannelTimeline("flash_bg"))
    io_stall_s: float = 0.0            # compute idle time waiting on data

    # asynchronous-prefetch traffic (a subset of the flash accumulators)
    n_prefetch_fills: int = 0
    prefetch_flash_bytes: float = 0.0
    prefetch_wasted_energy_j: float = 0.0

    # interconnect (all-to-all token dispatch under expert parallelism;
    # zero on every single-device run)
    ici_bytes: float = 0.0
    ici_latency_s: float = 0.0
    ici_energy_j: float = 0.0
    n_ici_transfers: int = 0
    ici_ch: ChannelTimeline = dataclasses.field(
        default_factory=lambda: ChannelTimeline("ici"))

    # expert-migration traffic (placement re-packing moving resident
    # slices shard-to-shard; a tagged subset of the ici accumulators)
    migration_bytes: float = 0.0
    n_migrations: int = 0

    # optional observability sink (repro_torch.obs.timeline.TimelineTracer):
    # when attached, every charge emits exactly one TraceEvent after its
    # channel span is issued.  shard_id stamps which shard's channels
    # these are (-1 = the shared interconnect sub-ledger).  Detached on
    # clone(): forked hypothetical timelines are untraced.
    tracer: Optional[object] = None
    shard_id: int = 0

    # ------------------------------------------------------------ timeline
    @property
    def now(self) -> float:
        """The timeline frontier: completion time of the latest event."""
        return max(self.flash_ch.busy_until, self.dram_ch.busy_until,
                   self.compute_ch.busy_until, self.ici_ch.busy_until)

    def _io_ready(self) -> float:
        if self.overlap_io_compute:
            return max(self.flash_ch.busy_until, self.dram_ch.busy_until)
        return self.now

    def _compute_ready(self) -> float:
        if self.overlap_io_compute:
            return self.compute_ch.busy_until
        return self.now

    # ------------------------------------------------- event API (timed)
    def fill_at(self, t_ready: float, nbytes: float, *,
                prefetch: bool = False,
                dram_write: bool = True) -> Tuple[float, float]:
        """Flash read issued at ``t_ready``; returns its (start, end) span.
        ``dram_write`` distinguishes a Flash → DRAM fill from a direct
        Flash → XPU stream (dropped fill, no DRAM write); ``prefetch``
        tags a speculative fill in the prefetch counters."""
        sysspec = self.system
        self.flash_bytes += nbytes
        self.n_flash_transfers += 1
        dur = sysspec.flash.transfer_latency_s(nbytes)
        self.flash_latency_s += dur
        self.flash_energy_j += sysspec.flash.transfer_energy_j(nbytes)
        if dram_write:
            self.dram_energy_j += sysspec.dram.transfer_energy_j(nbytes)
        if prefetch:
            self.n_prefetch_fills += 1
            self.prefetch_flash_bytes += nbytes
        span = self.flash_ch.issue(t_ready, dur)
        if self.tracer is not None:
            self.tracer.emit("prefetch_fill" if prefetch else "fill",
                             "flash", self.shard_id, span[0], span[1],
                             nbytes=nbytes)
        return span

    def prefetch_fill_at(self, t_ready: Optional[float],
                         nbytes: float) -> Tuple[float, float]:
        """Background-priority speculative Flash → DRAM fill.

        Demand fills preempt: the fill starts once the demand frontier at
        issue time has drained and occupies a separate background lane
        whose completion does not extend the makespan.  Energy and
        traffic are charged in full.  The returned ``end`` is the
        earliest the slice is usable.  ``t_ready=None`` issues at the
        serialized IO frontier (:meth:`_io_ready`).  Only the
        request-level predictor's fills ride this lane; the transition
        baseline's go through :meth:`fill_at` / :meth:`miss_fill` in FIFO
        order with demand.
        """
        if t_ready is None:
            t_ready = self._io_ready()
        sysspec = self.system
        self.flash_bytes += nbytes
        self.n_flash_transfers += 1
        dur = sysspec.flash.transfer_latency_s(nbytes)
        self.flash_latency_s += dur
        self.flash_energy_j += sysspec.flash.transfer_energy_j(nbytes)
        self.dram_energy_j += sysspec.dram.transfer_energy_j(nbytes)
        self.n_prefetch_fills += 1
        self.prefetch_flash_bytes += nbytes
        span = self.flash_bg_ch.issue(
            max(t_ready, self.flash_ch.busy_until), dur)
        if self.tracer is not None:
            self.tracer.emit("prefetch_fill", "flash_bg", self.shard_id,
                             span[0], span[1], nbytes=nbytes)
        return span

    def flash_stream_at(self, t_ready: float,
                        nbytes: float) -> Tuple[float, float]:
        """Flash → XPU direct stream for a slice the cache cannot hold."""
        return self.fill_at(t_ready, nbytes, dram_write=False)

    def dram_read_at(self, t_ready: float,
                     nbytes: float) -> Tuple[float, float]:
        """DRAM → XPU weight fetch, issued after its fill completes."""
        sysspec = self.system
        self.dram_bytes += nbytes
        self.n_dram_transfers += 1
        dur = sysspec.dram.transfer_latency_s(nbytes)
        self.dram_latency_s += dur
        self.dram_energy_j += sysspec.dram.transfer_energy_j(nbytes)
        span = self.dram_ch.issue(t_ready, dur)
        if self.tracer is not None:
            self.tracer.emit("dram_read", "dram", self.shard_id,
                             span[0], span[1], nbytes=nbytes)
        return span

    def matmul_at(self, t_ready: float, tokens: int, d_in: int, d_out: int,
                  bits: int) -> Tuple[float, float]:
        """Expert (or dense) matmul whose weights are available at
        ``t_ready``; compute-channel idle time before it is io_stall_s."""
        sysspec = self.system
        ops = 2.0 * tokens * d_in * d_out
        native = sysspec.compute.native_precision_bits
        speedup = max(1.0, native / max(bits, 1))
        dur = ops / (sysspec.compute.peak_ops_per_s * speedup)
        self.compute_ops += ops
        self.n_matmuls += 1
        self.compute_latency_s += dur
        # Energy scales with switched bit-width on a bit-sliced PE array.
        self.compute_energy_j += (
            sysspec.compute.energy_j_per_op * ops * (min(bits, native) / native)
        )
        self.io_stall_s += max(0.0, t_ready - self.compute_ch.busy_until)
        span = self.compute_ch.issue(t_ready, dur)
        if self.tracer is not None:
            self.tracer.emit("matmul", "compute", self.shard_id,
                             span[0], span[1], ops=ops, bits=bits)
        return span

    def _ici_issue(self, t_ready: float, nbytes: float,
                   kind: str) -> Tuple[float, float]:
        tier = self.system.interconnect or self.system.dram
        self.ici_bytes += nbytes
        self.n_ici_transfers += 1
        dur = tier.transfer_latency_s(nbytes)
        self.ici_latency_s += dur
        self.ici_energy_j += tier.transfer_energy_j(nbytes)
        span = self.ici_ch.issue(t_ready, dur)
        if self.tracer is not None:
            self.tracer.emit(kind, "ici", self.shard_id,
                             span[0], span[1], nbytes=nbytes)
        return span

    def ici_transfer_at(self, t_ready: float,
                        nbytes: float) -> Tuple[float, float]:
        """Shard-to-shard transfer (all-to-all token dispatch + combine)
        on the interconnect channel, at the system's ``interconnect``
        tier's rates (the DRAM tier's when the profile defines none)."""
        return self._ici_issue(t_ready, nbytes, "a2a")

    def ici_transfer(self, nbytes: float) -> None:
        """Serialized-issue interconnect transfer (blocking)."""
        self.ici_transfer_at(self._io_ready(), nbytes)

    def migrate_at(self, t_ready: float, nbytes: float) -> Tuple[float, float]:
        """One expert slice moved shard-to-shard by placement
        re-packing: interconnect latency + energy for its bytes, tagged in
        ``migration_bytes`` / ``n_migrations``."""
        self.migration_bytes += nbytes
        self.n_migrations += 1
        return self._ici_issue(t_ready, nbytes, "migrate")

    def migrate(self, nbytes: float) -> None:
        """Serialized-issue migration transfer (blocking)."""
        self.migrate_at(self._io_ready(), nbytes)

    def mark_prefetch_wasted(self, nbytes: float) -> None:
        """Attribute an already-charged prefetch fill as wasted (never
        demanded, or evicted before use).  Informational: the Flash read
        and DRAM write energy was spent at issue time and stays spent."""
        sysspec = self.system
        self.prefetch_wasted_energy_j += (
            sysspec.flash.transfer_energy_j(nbytes)
            + sysspec.dram.transfer_energy_j(nbytes))

    # ---------------------------------------- serialized (legacy) events
    def miss_fill(self, nbytes: float, *, prefetch: bool = False) -> None:
        """Flash -> DRAM fill caused by a slice miss (blocking issue);
        ``prefetch`` tags speculative fills in the traffic counters."""
        self.fill_at(self._io_ready(), nbytes, prefetch=prefetch)

    def flash_stream(self, nbytes: float) -> None:
        """Direct Flash -> XPU stream for a dropped fill (blocking)."""
        self.flash_stream_at(self._io_ready(), nbytes)

    def dram_read(self, nbytes: float) -> None:
        """DRAM -> XPU weight fetch (hit path or post-fill use)."""
        self.dram_read_at(self._io_ready(), nbytes)

    def matmul(self, tokens: int, d_in: int, d_out: int, bits: int) -> None:
        """Expert (or dense) matmul at the given weight precision."""
        t_ready = self._compute_ready()
        # Serialized issue is a modeling choice, not a data dependency —
        # don't let it masquerade as IO stall.
        stall0 = self.io_stall_s
        self.matmul_at(t_ready, tokens, d_in, d_out, bits)
        self.io_stall_s = stall0

    # -------------------------------------------------------------- summary
    @property
    def io_latency_s(self) -> float:
        return self.flash_latency_s + self.dram_latency_s \
            + self.ici_latency_s

    @property
    def serial_latency_s(self) -> float:
        """What a fully serialized replay of the same events would take."""
        return self.io_latency_s + self.compute_latency_s

    @property
    def total_latency_s(self) -> float:
        """Timeline makespan."""
        return self.now

    @property
    def overlap_saved_s(self) -> float:
        """Latency hidden by channel overlap (0 when fully serialized)."""
        return max(0.0, self.serial_latency_s - self.total_latency_s)

    @property
    def total_energy_j(self) -> float:
        return self.flash_energy_j + self.dram_energy_j \
            + self.compute_energy_j + self.ici_energy_j

    def snapshot(self) -> dict:
        return {
            "flash_bytes": self.flash_bytes,
            "dram_bytes": self.dram_bytes,
            "compute_ops": self.compute_ops,
            "flash_latency_s": self.flash_latency_s,
            "dram_latency_s": self.dram_latency_s,
            "compute_latency_s": self.compute_latency_s,
            "total_latency_s": self.total_latency_s,
            "serial_latency_s": self.serial_latency_s,
            "overlap_saved_s": self.overlap_saved_s,
            "io_stall_s": self.io_stall_s,
            "flash_busy_s": self.flash_ch.busy_s,
            "dram_busy_s": self.dram_ch.busy_s,
            "compute_busy_s": self.compute_ch.busy_s,
            "ici_busy_s": self.ici_ch.busy_s,
            "flash_energy_j": self.flash_energy_j,
            "dram_energy_j": self.dram_energy_j,
            "compute_energy_j": self.compute_energy_j,
            "total_energy_j": self.total_energy_j,
            "n_flash_transfers": self.n_flash_transfers,
            "n_dram_transfers": self.n_dram_transfers,
            "n_matmuls": self.n_matmuls,
            "n_prefetch_fills": self.n_prefetch_fills,
            "prefetch_flash_bytes": self.prefetch_flash_bytes,
            "prefetch_wasted_energy_j": self.prefetch_wasted_energy_j,
            "ici_bytes": self.ici_bytes,
            "ici_latency_s": self.ici_latency_s,
            "ici_energy_j": self.ici_energy_j,
            "n_ici_transfers": self.n_ici_transfers,
            "migration_bytes": self.migration_bytes,
            "n_migrations": self.n_migrations,
        }

    def clone(self) -> "CostLedger":
        """Deep copy of the full ledger (accumulators + channel clocks):
        the replay simulator forks a timeline mid-trace with it.  An
        attached tracer stays with the original: forked hypothetical
        timelines must not interleave events into a real capture."""
        tracer, self.tracer = self.tracer, None
        try:
            return copy.deepcopy(self)
        finally:
            self.tracer = tracer

    def delta_since(self, prev: Optional[dict]) -> dict:
        cur = self.snapshot()
        if prev is None:
            return cur
        return {k: cur[k] - prev.get(k, 0.0) for k in cur}

    def reset(self) -> None:
        for f in (
            "flash_bytes", "dram_bytes", "compute_ops",
            "flash_latency_s", "dram_latency_s", "compute_latency_s",
            "flash_energy_j", "dram_energy_j", "compute_energy_j",
            "io_stall_s", "prefetch_flash_bytes",
            "prefetch_wasted_energy_j",
            "ici_bytes", "ici_latency_s", "ici_energy_j",
            "migration_bytes",
        ):
            setattr(self, f, 0.0)
        self.n_flash_transfers = 0
        self.n_dram_transfers = 0
        self.n_matmuls = 0
        self.n_prefetch_fills = 0
        self.n_ici_transfers = 0
        self.n_migrations = 0
        for ch in (self.flash_ch, self.dram_ch, self.compute_ch,
                   self.flash_bg_ch, self.ici_ch):
            ch.reset()


class ShardedCostLedger:
    """Expert-parallel cost ledger: one :class:`CostLedger` per shard
    plus a shared interconnect sub-ledger for all-to-all token dispatch.

    Each shard carries its own Flash/DRAM/XPU channel clocks, so the
    per-step latency of an expert-parallel decode is the *max* over the
    shard timelines rather than the sum a single-device timeline would
    charge.  Energy and traffic accumulators sum across shards, and the
    all-to-all bytes/energy live on the interconnect sub-ledger's
    ``ici_*`` accumulators.  The aggregate exposes the read API of a
    plain :class:`CostLedger` (``snapshot`` / ``delta_since`` /
    ``total_latency_s`` / ``total_energy_j`` / ...); the engine routes
    each expert's events to its owning shard via :attr:`shards`.  With
    one shard and no interconnect events every aggregate equals the
    single ledger's value exactly.
    """

    def __init__(self, system: SystemSpec, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.system = system
        self.n_shards = int(n_shards)
        self.shards = [CostLedger(system=system, shard_id=sid)
                       for sid in range(self.n_shards)]
        # Dedicated sub-ledger for the shared interconnect channel; its
        # flash/dram/compute channels never see an event.
        self.ici = CostLedger(system=system, shard_id=-1)

    # ------------------------------------------------------------ routing
    def shard_for(self, shard: int) -> CostLedger:
        return self.shards[shard]

    def ici_transfer_at(self, t_ready: float, nbytes: float):
        return self.ici.ici_transfer_at(t_ready, nbytes)

    def ici_transfer(self, nbytes: float) -> None:
        self.ici.ici_transfer(nbytes)

    def migrate_at(self, t_ready: float, nbytes: float):
        return self.ici.migrate_at(t_ready, nbytes)

    def migrate(self, nbytes: float) -> None:
        self.ici.migrate(nbytes)

    # ------------------------------------------------------ observability
    @property
    def tracer(self):
        return self.shards[0].tracer

    def attach_tracer(self, tracer) -> None:
        """Point every shard ledger (and the interconnect sub-ledger) at
        one shared event sink; shard ids stamp the per-shard channel
        tracks, the interconnect gets shard id -1.  ``None`` detaches."""
        for sid, led in enumerate(self.shards):
            led.tracer = tracer
            led.shard_id = sid
        self.ici.tracer = tracer
        self.ici.shard_id = -1

    # ----------------------------------------------------------- timeline
    @property
    def now(self) -> float:
        """Makespan frontier: the latest completion over every shard's
        channels and the interconnect."""
        return max([led.now for led in self.shards] + [self.ici.now])

    def compute_frontier(self) -> float:
        """Latest compute-channel completion across shards: the instant
        a step's (globally synchronized) routing can be derived."""
        return max(led.compute_ch.busy_until for led in self.shards)

    # ------------------------------------------------------------ summary
    @property
    def total_latency_s(self) -> float:
        return self.now

    @property
    def serial_latency_s(self) -> float:
        """What a fully serialized single-device replay of every shard's
        events (plus the dispatch traffic) would take."""
        return sum(led.serial_latency_s for led in self.shards) \
            + self.ici.ici_latency_s

    @property
    def overlap_saved_s(self) -> float:
        return max(0.0, self.serial_latency_s - self.total_latency_s)

    @property
    def total_energy_j(self) -> float:
        return sum(led.total_energy_j for led in self.shards) \
            + self.ici.total_energy_j

    @property
    def prefetch_wasted_energy_j(self) -> float:
        return sum(led.prefetch_wasted_energy_j for led in self.shards)

    @property
    def migration_bytes(self) -> float:
        return self.ici.migration_bytes \
            + sum(led.migration_bytes for led in self.shards)

    @property
    def n_migrations(self) -> int:
        return self.ici.n_migrations \
            + sum(led.n_migrations for led in self.shards)

    @property
    def io_stall_s(self) -> float:
        return sum(led.io_stall_s for led in self.shards)

    def snapshot(self) -> dict:
        """Aggregate snapshot: accumulators summed across shards (and the
        interconnect), makespan-derived fields recomputed from the
        aggregate timelines."""
        out = self.shards[0].snapshot()
        # The ici sub-ledger's flash/dram/compute accumulators are always
        # zero, so folding its full snapshot in adds only the ici_* keys.
        for led in self.shards[1:] + [self.ici]:
            snap = led.snapshot()
            for k in out:
                out[k] += snap[k]
        out["total_latency_s"] = self.total_latency_s
        out["serial_latency_s"] = self.serial_latency_s
        out["overlap_saved_s"] = self.overlap_saved_s
        return out

    def per_shard_snapshots(self) -> list:
        return [led.snapshot() for led in self.shards]

    def delta_since(self, prev: Optional[dict]) -> dict:
        cur = self.snapshot()
        if prev is None:
            return cur
        return {k: cur[k] - prev.get(k, 0.0) for k in cur}

    def clone(self) -> "ShardedCostLedger":
        tracer = self.tracer
        self.attach_tracer(None)
        try:
            new = copy.deepcopy(self)
        finally:
            if tracer is not None:
                self.attach_tracer(tracer)
        return new

    def reset(self) -> None:
        for led in self.shards:
            led.reset()
        self.ici.reset()
