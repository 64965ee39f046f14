"""Hardware specifications (port of ``repro.hw.specs``).

Two cost-model profiles that the ledger charges expert-slice traffic
against: ``MOBILE_SOC``, the paper's Fig. 7 system (systolic XPU +
LPDDR4 DRAM + UFS 3.1 Flash), and ``TPU_OFFLOAD``, the reference's
``tpu_offload`` profile, whose constants are copied so that a trace
recorded under it replays to the same totals here.  Both are simulated
devices, not the card the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    """One tier of the offload hierarchy.

    ``access_latency_s`` is a fixed per-transfer issue cost (command +
    seek), paid once per transfer on top of the bandwidth term — the
    knob that makes many small slice fills slower than one large fill on
    the event timeline.  Both shipped profiles keep it at 0.0: the
    paper's Fig. 7 bandwidth numbers are *effective* rates with access
    overheads folded in, and the persisted Fig. 9-10 / benchmark
    baselines are calibrated against them.
    """

    name: str
    bandwidth_bytes_per_s: float
    energy_pj_per_bit: float
    capacity_bytes: float
    access_latency_s: float = 0.0

    @property
    def energy_j_per_byte(self) -> float:
        return self.energy_pj_per_bit * 8 * 1e-12

    def transfer_latency_s(self, nbytes: float) -> float:
        return self.access_latency_s + nbytes / self.bandwidth_bytes_per_s

    def transfer_energy_j(self, nbytes: float) -> float:
        return nbytes * self.energy_j_per_byte


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Compute engine spec (the XPU in the paper)."""

    name: str
    peak_ops_per_s: float          # at the native precision below
    ops_per_watt: float            # energy efficiency (paper: 3.18 TOPS/W)
    native_precision_bits: int

    @property
    def energy_j_per_op(self) -> float:
        return 1.0 / self.ops_per_watt

    def compute_latency_s(self, ops: float, utilization: float = 1.0) -> float:
        return ops / (self.peak_ops_per_s * max(utilization, 1e-9))

    def compute_energy_j(self, ops: float) -> float:
        return ops * self.energy_j_per_op


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A full offload system: compute + fast tier (cache) + slow tier.

    ``interconnect`` models the device-to-device link the expert-parallel
    serving mode charges all-to-all token dispatch on (``None`` keeps the
    cost model single-device; the sharded ledger falls back to the DRAM
    tier's rates if asked anyway).  Its ``capacity_bytes`` is
    meaningless for a link and set to ``inf``.
    """

    name: str
    compute: ComputeSpec
    dram: MemoryTier        # the expert-cache tier
    flash: MemoryTier       # the backing store (miss target)
    interconnect: Optional[MemoryTier] = None   # shard-to-shard link

    @property
    def miss_penalty_ratio_bw(self) -> float:
        return self.dram.bandwidth_bytes_per_s / self.flash.bandwidth_bytes_per_s

    @property
    def miss_penalty_ratio_energy(self) -> float:
        return self.flash.energy_pj_per_bit / self.dram.energy_pj_per_bit


# --- Paper Fig. 7: mobile SoC profile --------------------------------------
# XPU: 1 GHz systolic array, 8192 8-bit PEs -> 16.4 TOPS, 3.18 TOPS/W.
# DRAM: LPDDR4, ~104 Gbps, 8 GB, 1.5 pJ/bit.
# Flash: UFS 3.1, 10 Gbps, 128 GB, 103 pJ/bit.
MOBILE_SOC = SystemSpec(
    name="mobile_soc",
    compute=ComputeSpec(
        name="xpu_systolic_8192pe",
        peak_ops_per_s=16.4e12,
        ops_per_watt=3.18e12,
        native_precision_bits=8,
    ),
    dram=MemoryTier(
        name="lpddr4",
        bandwidth_bytes_per_s=104e9 / 8,   # 104 Gbps -> 13 GB/s
        energy_pj_per_bit=1.5,
        capacity_bytes=8 * 2**30,
    ),
    flash=MemoryTier(
        name="ufs3.1",
        bandwidth_bytes_per_s=10e9 / 8,    # 10 Gbps -> 1.25 GB/s
        energy_pj_per_bit=103.0,
        capacity_bytes=128 * 2**30,
    ),
    # Die-to-die NoC/D2D link for the multi-die expert-parallel variant
    # of the SoC: faster than Flash, slower and costlier per bit than
    # on-die LPDDR (UCIe-class effective rates; a modeling choice, the
    # paper's single-device figures never touch it).
    interconnect=MemoryTier(
        name="d2d_link",
        bandwidth_bytes_per_s=32e9,
        energy_pj_per_bit=2.0,
        capacity_bytes=float("inf"),
    ),
)

# The reference's ``tpu_offload`` cost-model constants
# (``repro/hw/specs.py:162-193``), copied field for field for replay
# parity: the ledger reads them as a simulated system's rates, and they
# describe no device this package runs on.
TPU_OFFLOAD = SystemSpec(
    name="tpu_offload",
    compute=ComputeSpec(
        name="tpu_v5e_chip",
        peak_ops_per_s=197e12 * 2,
        ops_per_watt=197e12 / 170,
        native_precision_bits=8,
    ),
    dram=MemoryTier(
        name="hbm",
        bandwidth_bytes_per_s=819e9,
        energy_pj_per_bit=0.5,
        capacity_bytes=16 * 2**30,
    ),
    flash=MemoryTier(
        name="host_dram_dma",
        bandwidth_bytes_per_s=32e9,
        energy_pj_per_bit=15.0,
        capacity_bytes=512 * 2**30,
    ),
    interconnect=MemoryTier(
        name="ici",
        bandwidth_bytes_per_s=50e9,
        energy_pj_per_bit=0.5,
        capacity_bytes=float("inf"),
    ),
)

SYSTEM_PROFILES = {
    "mobile_soc": MOBILE_SOC,
    "tpu_offload": TPU_OFFLOAD,
}
