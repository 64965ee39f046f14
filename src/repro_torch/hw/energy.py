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
  durations;
* the event methods the async charge path uses (:meth:`~CostLedger.fill_at`,
  :meth:`~CostLedger.dram_read_at`, :meth:`~CostLedger.matmul_at`,
  :meth:`~CostLedger.prefetch_fill_at`) take an explicit data-dependency
  time, so fills overlap compute and speculative fills ride a background
  Flash lane.

Energy is time-independent, so both disciplines charge the same energy
for the same events.  The ledger here is the single-device one with its
prefetch lane; the interconnect and migration charges, ``reset``, the
tracer hook and ``ShardedCostLedger`` are ROADMAP.md queue 1, 'EP,
placement, control' and 'Observability'.  Their accumulators stay in
:meth:`CostLedger.snapshot` at zero so a snapshot compares key for key
with the reference's.
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


@dataclasses.dataclass
class CostLedger:
    """Event-timeline latency + energy ledger over a simulated run."""

    system: SystemSpec = dataclasses.field(default_factory=lambda: MOBILE_SOC)

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

    # Interconnect and migration charges (ROADMAP.md queue 1, 'EP,
    # placement, control'): zero on one device, kept so snapshots share
    # the reference's keys.
    ici_bytes: float = 0.0
    ici_latency_s: float = 0.0
    ici_energy_j: float = 0.0
    n_ici_transfers: int = 0
    ici_busy_s: float = 0.0
    migration_bytes: float = 0.0
    n_migrations: int = 0

    # ------------------------------------------------------------ timeline
    @property
    def now(self) -> float:
        """The timeline frontier: completion time of the latest event."""
        return max(self.flash_ch.busy_until, self.dram_ch.busy_until,
                   self.compute_ch.busy_until)

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
        return self.flash_ch.issue(t_ready, dur)

    def prefetch_fill_at(self, t_ready: Optional[float],
                         nbytes: float) -> Tuple[float, float]:
        """Background-priority speculative Flash → DRAM fill.

        Demand fills preempt: the fill starts once the demand frontier at
        issue time has drained and occupies a separate background lane
        whose completion does not extend the makespan.  Energy and
        traffic are charged in full.  The returned ``end`` is the
        earliest the slice is usable.  ``t_ready=None`` issues at the
        ledger's frontier (:attr:`now`).  Only the request-level predictor's fills
        ride this lane; the transition baseline's go through
        :meth:`fill_at` / :meth:`miss_fill` in FIFO order with demand.
        """
        if t_ready is None:
            t_ready = self.now
        sysspec = self.system
        self.flash_bytes += nbytes
        self.n_flash_transfers += 1
        dur = sysspec.flash.transfer_latency_s(nbytes)
        self.flash_latency_s += dur
        self.flash_energy_j += sysspec.flash.transfer_energy_j(nbytes)
        self.dram_energy_j += sysspec.dram.transfer_energy_j(nbytes)
        self.n_prefetch_fills += 1
        self.prefetch_flash_bytes += nbytes
        return self.flash_bg_ch.issue(
            max(t_ready, self.flash_ch.busy_until), dur)

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
        return self.dram_ch.issue(t_ready, dur)

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
        return self.compute_ch.issue(t_ready, dur)

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
        self.fill_at(self.now, nbytes, prefetch=prefetch)

    def flash_stream(self, nbytes: float) -> None:
        """Direct Flash -> XPU stream for a dropped fill (blocking)."""
        self.flash_stream_at(self.now, nbytes)

    def dram_read(self, nbytes: float) -> None:
        """DRAM -> XPU weight fetch (hit path or post-fill use)."""
        self.dram_read_at(self.now, nbytes)

    def matmul(self, tokens: int, d_in: int, d_out: int, bits: int) -> None:
        """Expert (or dense) matmul at the given weight precision."""
        t_ready = self.now
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
            "ici_busy_s": self.ici_busy_s,
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
        the replay simulator forks a timeline mid-trace with it."""
        return copy.deepcopy(self)

    def delta_since(self, prev: Optional[dict]) -> dict:
        cur = self.snapshot()
        if prev is None:
            return cur
        return {k: cur[k] - prev.get(k, 0.0) for k in cur}
