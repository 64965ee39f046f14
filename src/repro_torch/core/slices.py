"""Bit-sliced expert weight store (port of ``repro.core.slices``).

One AMAT high-bit code buffer per (layer, expert) weight matrix; the MSB
and LSB *slices* are views of that buffer (shift / mask), so mixed
precision costs no extra weight memory.  The store serves the cache
simulator (slice byte sizes and :class:`SliceKey` identities) and the
model (stacked ``QuantizedTensor`` expert weights).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from repro_torch.core.amat import (MatConfig, amat_quantize,
                                   amat_quantize_stacked, slice_nbytes)
from repro_torch.quant.groupquant import QuantizedTensor


class SliceKey(NamedTuple):
    layer: int
    expert: int
    kind: str          # 'msb' | 'lsb'


@dataclasses.dataclass
class LayerExperts:
    """Stacked AMAT-quantized expert weights for one MoE layer."""

    wi_q: QuantizedTensor          # codes [E, d, F(|2F)]
    wo_q: QuantizedTensor          # codes [E, F, d]

    @property
    def n_experts(self) -> int:
        return self.wi_q.codes.shape[0]


def _slice_bytes(le: LayerExperts, mat: MatConfig, which: str) -> float:
    return sum(slice_nbytes(tuple(q.codes.shape[1:]), mat.high_bits,
                            mat.group_size, which=which, shift=mat.shift)
               for q in (le.wi_q, le.wo_q))


@dataclasses.dataclass
class ExpertSliceStore:
    """All MoE layers' expert weights in AMAT form + slice-size metadata."""

    mat: MatConfig
    layers: Dict[int, LayerExperts]
    msb_bytes_per_expert: float = 0.0
    lsb_bytes_per_expert: float = 0.0

    @classmethod
    def from_float(cls, expert_weights: Dict[int, dict],
                   mat: MatConfig) -> "ExpertSliceStore":
        """expert_weights: {layer: {'wi': [E,d,F], 'wo': [E,F,d]}} floats."""
        layers = {}
        msb_b = lsb_b = 0.0
        for lidx, w in expert_weights.items():
            le = LayerExperts(wi_q=amat_quantize(w["wi"], mat),
                              wo_q=amat_quantize(w["wo"], mat))
            layers[lidx] = le
            msb_b = _slice_bytes(le, mat, "msb")
            lsb_b = _slice_bytes(le, mat, "lsb")
        return cls(mat=mat, layers=layers,
                   msb_bytes_per_expert=msb_b, lsb_bytes_per_expert=lsb_b)

    # ------------------------------------------------------------ metadata
    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_experts(self) -> int:
        return next(iter(self.layers.values())).n_experts

    def slice_bytes(self, key: SliceKey) -> float:
        return (self.msb_bytes_per_expert if key.kind == "msb"
                else self.lsb_bytes_per_expert)

    def highbit_expert_bytes(self) -> float:
        return self.msb_bytes_per_expert + self.lsb_bytes_per_expert

    def total_bytes(self) -> float:
        return self.highbit_expert_bytes() * self.n_layers * self.n_experts

    def all_keys(self):
        for lidx in self.layers:
            for e in range(self.n_experts):
                yield SliceKey(lidx, e, "msb")
                yield SliceKey(lidx, e, "lsb")

    # ------------------------------------------------------- compute views
    def layer_weights(self, layer: int) -> LayerExperts:
        return self.layers[layer]

    def use_lsb_mask(self, layer: int, resident_lsb) -> torch.Tensor:
        """The model's per-expert mask from the cache's LSB residency
        row: a bool tensor on the store's device."""
        dev = next(iter(self.layers.values())).wi_q.codes.device
        return torch.as_tensor(resident_lsb, dtype=torch.bool, device=dev)


def quantize_moe_params(params: dict, cfg, mat: MatConfig, *,
                        quant_execution: bool = False):
    """Replace float expert weights in a model param tree by AMAT tensors.

    Returns (new_params, store, layer_map).  The tree keeps
    ``QuantizedTensor`` leaves under ``experts/{wi_q, wo_q}``; the store
    indexes the same tensors by *flat layer index* for the cache sim.
    ``quant_execution`` additionally stores the ``wo`` codes transposed
    to the output-major ``[..., d_model, d_ff]`` layout under
    ``experts/wo_codes_t`` (the transposed kernel's input).
    """
    pattern = cfg.block_pattern
    new_blocks = dict(params["blocks"])
    store_layers: Dict[int, LayerExperts] = {}

    flat_idx = 0
    layer_map = {}   # (pos, period) -> flat moe layer index
    for period in range(cfg.n_periods):
        for i, spec in enumerate(pattern):
            if spec.ffn == "moe":
                layer_map[(i, period)] = flat_idx
                flat_idx += 1

    msb_b = lsb_b = 0.0
    for i, spec in enumerate(pattern):
        if spec.ffn != "moe":
            continue
        blk = dict(new_blocks[f"pos{i}"])
        experts = blk["moe"]["experts"]
        wi_q = amat_quantize_stacked(experts["wi"], mat)
        wo_q = amat_quantize_stacked(experts["wo"], mat)
        moe_p = dict(blk["moe"])
        moe_p["experts"] = {"wi_q": wi_q, "wo_q": wo_q}
        if quant_execution:
            moe_p["experts"]["wo_codes_t"] = \
                wo_q.codes.transpose(-1, -2).contiguous()
        blk["moe"] = moe_p
        new_blocks[f"pos{i}"] = blk
        for period in range(cfg.n_periods):
            le = LayerExperts(wi_q=wi_q.index(period),
                              wo_q=wo_q.index(period))
            store_layers[layer_map[(i, period)]] = le
            msb_b = _slice_bytes(le, mat, "msb")
            lsb_b = _slice_bytes(le, mat, "lsb")

    new_params = dict(params)
    new_params["blocks"] = new_blocks
    store = ExpertSliceStore(
        mat=mat, layers=store_layers,
        msb_bytes_per_expert=msb_b, lsb_bytes_per_expert=lsb_b)
    return new_params, store, layer_map
