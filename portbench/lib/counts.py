"""The benchmark's frozen yardstick: the H100's peaks and the operations
and bytes that a forward's inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3
3.35 TB/s (at the card's 700 W limit).

Counts follow the routing each forward really had (the program's routing
arrays ``ids``/``active``/``critical``, ``[*layout, T, k]``, where
``layout`` is the model module's ``moe_layout``):

* only experts that kept at least one row after the capacity limit, and
  only the rows they kept, never the padding of the ``[E, C, d]`` buffer;
* an expert's LSB slice only where the expert ran on both slices: in
  decode, where any of the step's selections of it was critical (DBSC);
  in prefill every expert runs at 8 bits;
* each input byte read once and each output byte written once: codes at
  the bits used, f32 scales and u8 zero-points per group of 32, the rows
  in (bf16) and out (f32, as the kernels write them);
* for a whole forward: the non-expert weights once (the embedding only
  for the rows looked up), the expert codes above, each sequence's KV rows
  up to its position and the one row written, a recurrent mixer's state
  read and written, and the logits written (f32).

The expert half is here; the non-expert terms (``LayerWork``) are each
configuration's model module's (``portbench/models/<model>.py``,
``layer_work``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from portbench.lib import loader
from portbench.lib.reference import capacity, keep_mask

PEAK_FLOPS_BF16 = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4
GROUP = 32


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, o: "Work") -> "Work":
        self.flops += o.flops
        self.bytes += o.bytes
        return self

    @property
    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS_BF16, self.bytes / PEAK_HBM_BYTES)


@dataclasses.dataclass(frozen=True)
class LayerWork:
    """A forward's non-expert terms, summed over the model's layers."""

    mm: int                  # matrix elements per token (no embeddings)
    weight_bytes: int        # their resident bytes, vectors included
    attn_flops_row: float    # attention flops per (query, context row)
    kv_bytes_row: int        # cached bytes per context row
    state_bytes: int         # recurrent state bytes per sequence
    scan_flops: int          # recurrent scan flops per token


def _gated(t: str) -> bool:
    return t in ("swiglu", "geglu")


def expert_rows(cfg: dict, ids: np.ndarray, active: np.ndarray,
                slot_mask: Optional[np.ndarray]) -> np.ndarray:
    """Kept rows per expert, [*layout, E], under the capacity rule over
    the forward's T tokens."""
    moe = cfg["moe"]
    E, k = moe["n_experts"], moe["top_k"]
    act = active if slot_mask is None else active & slot_mask[:, None]
    ids = np.where(act, ids, E)
    T = ids.shape[-2]
    keep = keep_mask(ids, E, capacity(T, k, E, moe["capacity_factor"]))
    onehot = (ids[..., None] == np.arange(E)) & keep[..., None]
    return onehot.sum(axis=(-3, -2))


def expert_high(cfg: dict, ids: np.ndarray, active: np.ndarray,
                critical: Optional[np.ndarray],
                slot_mask: Optional[np.ndarray]) -> np.ndarray:
    """[*layout, E] bool: the experts that ran on both slices."""
    E = cfg["moe"]["n_experts"]
    if critical is None:
        return np.ones(ids.shape[:-2] + (E,), bool)
    act = active if slot_mask is None else active & slot_mask[:, None]
    crit = critical & act
    onehot = (ids[..., None] == np.arange(E)) & crit[..., None]
    return onehot.any(axis=(-3, -2))


def _matrices(cfg: dict):
    moe = cfg["moe"]
    d, f = cfg["d_model"], moe["d_ff"]
    n_wi = 2 * f if _gated(moe["mlp_type"]) else f
    return (d, n_wi), (f, d)


def _weights(rows: np.ndarray, high: np.ndarray, K: int, N: int,
             mat_bits) -> float:
    """Code and group-metadata bytes of one matrix of the used experts."""
    used = rows > 0
    bits = np.where(high, mat_bits[0], mat_bits[1])[used]
    return float((bits * K * N / 8.0).sum()) \
        + float(used.sum()) * (K // GROUP) * N * (F32 + 1)


def kernel_work(cfg: dict, rows: np.ndarray, high: np.ndarray,
                mat_bits=(8, 4)):
    """(K1, K2) work of one MoE layer: ``rows`` [E], ``high`` [E]."""
    r = float(rows.sum())
    out = []
    for K, N in _matrices(cfg):
        out.append(Work(2.0 * r * K * N,
                        _weights(rows, high, K, N, mat_bits)
                        + r * K * BF16 + r * N * F32))
    return tuple(out)


def _experts(cfg, rows_all, high_all, mat_bits) -> Work:
    """Expert products of a forward: their flops, and the bytes of the
    used experts' codes and metadata (the rows are activations)."""
    w = Work()
    E = rows_all.shape[-1]
    for rows, high in zip(rows_all.reshape(-1, E), high_all.reshape(-1, E)):
        for K, N in _matrices(cfg):
            w.flops += 2.0 * float(rows.sum()) * K * N
            w.bytes += _weights(rows, high, K, N, mat_bits)
    return w


def _layers(cfg: dict, model) -> LayerWork:
    return (model or loader.model_module(cfg)).layer_work(cfg)


def decode_work(cfg: dict, ids, active, critical, slot_mask,
                kv_lens: Sequence[int], mat_bits=(8, 4), model=None) -> Work:
    """One batched decode step over the active sequences, each of whose
    KV holds ``kv_lens[b]`` rows after the step's row is written.
    ``model``: the configuration's model module (found by its name in
    ``cfg`` when not given)."""
    B = int(np.asarray(slot_mask).sum())
    L = _layers(cfg, model)
    d, V = cfg["d_model"], cfg["vocab_size"]
    w = Work()
    w.flops = 2.0 * B * (L.mm + d * V) + B * L.scan_flops
    ctx = float(sum(kv_lens))
    w.flops += L.attn_flops_row * ctx
    w.bytes = L.weight_bytes + d * V * BF16 + B * d * BF16 + B * V * F32
    w.bytes += L.kv_bytes_row * (ctx + B) + L.state_bytes * 2 * B
    w += _experts(cfg, expert_rows(cfg, ids, active, slot_mask),
                  expert_high(cfg, ids, active, critical, slot_mask),
                  mat_bits)
    return w


def prefill_work(cfg: dict, ids, active, n_tokens: int,
                 mat_bits=(8, 4), model=None) -> Work:
    """One request's prefill over ``n_tokens`` prompt tokens: last-token
    logits, every expert at 8 bits."""
    S = float(n_tokens)
    L = _layers(cfg, model)
    d, V = cfg["d_model"], cfg["vocab_size"]
    w = Work()
    w.flops = 2.0 * S * L.mm + 2.0 * d * V + S * L.scan_flops
    w.flops += L.attn_flops_row * S * (S + 1) / 2
    w.bytes = L.weight_bytes + d * V * BF16 + S * d * BF16 + S * 8 \
        + V * F32
    w.bytes += L.kv_bytes_row * S + L.state_bytes
    w += _experts(cfg, expert_rows(cfg, ids, active, None),
                  expert_high(cfg, ids, active, None, None), mat_bits)
    return w
