"""Hardware specifications (port of ``repro.hw.specs``).

Two cost-model profiles that the ledger charges expert-slice traffic
against: ``MOBILE_SOC``, the paper's Fig. 7 system (systolic XPU +
LPDDR4 DRAM + UFS 3.1 Flash), and ``TPU_OFFLOAD``, the reference's
``tpu_offload`` profile, whose constants are copied so that a trace
recorded under it replays to the same totals here.  Both are simulated
devices, not the card the port runs on.

Two roofline records: ``TPU_V5E`` (``TPUSpec``), the reference's, copied
under its name and read by nothing that describes the card, and
``H100`` (``GPUSpec``), the card's peaks and HBM rate, which the dry-run
(``launch/dryrun.py``) and ``chip_smoke.py``'s bounds read.
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

# --- Roofline records ------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPUSpec:
    """The reference's TPU roofline record (``repro/hw/specs.py:134-151``),
    copied under its name.  ``TPU_V5E`` describes no device this package
    runs on; the port's dry-run and chip checks read :data:`H100`."""

    name: str
    peak_flops_bf16: float
    hbm_bytes_per_s: float
    ici_bytes_per_s_per_link: float
    hbm_capacity_bytes: float
    vmem_bytes: float

    def compute_term_s(self, flops: float, chips: int) -> float:
        return flops / (chips * self.peak_flops_bf16)

    def memory_term_s(self, hbm_bytes: float, chips: int) -> float:
        return hbm_bytes / (chips * self.hbm_bytes_per_s)

    def collective_term_s(self, coll_bytes: float, chips: int) -> float:
        return coll_bytes / (chips * self.ici_bytes_per_s_per_link)


TPU_V5E = TPUSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bytes_per_s=819e9,
    ici_bytes_per_s_per_link=50e9,
    hbm_capacity_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
)


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """The roofline constants of one card: dense peaks by operand type
    (``peak_flops``: bf16 and tf32 on the tensor cores, f32 on the CUDA
    cores) and the HBM rate.  No collective term: the port runs on one
    card and has no partitioner that would insert collectives."""

    name: str
    peak_flops_bf16: float
    peak_flops_tf32: float
    peak_flops_f32: float
    hbm_bytes_per_s: float
    hbm_capacity_bytes: float

    @property
    def peak_flops(self) -> dict:
        """Peak operations per second by operand type."""
        return {"bf16": self.peak_flops_bf16, "tf32": self.peak_flops_tf32,
                "f32": self.peak_flops_f32}

    def compute_term_s(self, flops: float, chips: int) -> float:
        return flops / (chips * self.peak_flops_bf16)

    def memory_term_s(self, hbm_bytes: float, chips: int) -> float:
        return hbm_bytes / (chips * self.hbm_bytes_per_s)


# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit: bf16
# and TF32 on the tensor cores (a bf16 x bf16 or tf32 x tf32 product is
# exact in an f32 accumulator), f32 on the CUDA cores; 80 GB of HBM3.
H100 = GPUSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    peak_flops_tf32=494.7e12,
    peak_flops_f32=67e12,
    hbm_bytes_per_s=3.35e12,
    hbm_capacity_bytes=80e9,
)

SYSTEM_PROFILES = {
    "mobile_soc": MOBILE_SOC,
    "tpu_offload": TPU_OFFLOAD,
}
