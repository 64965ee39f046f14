"""Calibration-Free Asymmetric Matryoshka Quantization (AMAT) — paper §4.2.

Port of ``repro.core.amat``.  One high-bit asymmetric group-quantized
tensor stores *both* precisions; the low-bit view truncates the code
**and** the zero-point by the same bit offset::

    shift   = b_high - b_low
    q_low   = floor(q_high / 2**shift)      # MSB slice
    zp_low  = floor(zp_high / 2**shift)
    s_low   = s_high * 2**shift

The LSB slice ``q_high & (2**shift - 1)`` is the upgrade payload:
``(msb << shift) | lsb`` reconstructs the high-bit code losslessly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.groupquant import QuantizedTensor, dequantize, quantize


@dataclasses.dataclass(frozen=True)
class MatConfig:
    """A Matryoshka MAT(h, l) configuration, e.g. MAT84 = (8, 4)."""

    high_bits: int
    low_bits: int
    group_size: int = 32

    @property
    def shift(self) -> int:
        return self.high_bits - self.low_bits

    @property
    def name(self) -> str:
        return f"MAT{self.high_bits}{self.low_bits}"


MAT42 = MatConfig(4, 2)
MAT63 = MatConfig(6, 3)
MAT84 = MatConfig(8, 4)
PAPER_CONFIGS = (MAT42, MAT63, MAT84)


def amat_quantize(w: torch.Tensor, cfg: MatConfig) -> QuantizedTensor:
    """Quantize ``w`` at the *high* bit-width; the low-bit view is free."""
    return quantize(w, bits=cfg.high_bits, group_size=cfg.group_size,
                    asymmetric=True)


def empty_stacked(shape, cfg: MatConfig, device) -> QuantizedTensor:
    """An uninitialized AMAT tensor of weight shape ``[..., K, N]``."""
    *lead, K, N = shape
    g_shape = (*lead, K // cfg.group_size, N)
    return QuantizedTensor(
        torch.empty(shape, dtype=torch.uint8, device=device),
        torch.empty(g_shape, dtype=torch.float32, device=device),
        torch.empty(g_shape, dtype=torch.uint8, device=device),
        cfg.high_bits, cfg.group_size, True)


@torch.no_grad()
def amat_quantize_stacked(w: torch.Tensor, cfg: MatConfig,
                          out: Optional[QuantizedTensor] = None
                          ) -> QuantizedTensor:
    """AMAT-quantize a stack ``[..., K, N]`` one ``[K, N]`` matrix at a
    time, into ``out`` when given (contiguous, of ``w``'s shape).

    The reference casts the whole stack to f32 first; for
    Qwen1.5-MoE-A2.7B at full width that is a 33 GB temporary for ``wi``
    alone, and one period of Jamba's ``wi`` (16 x 4096 x 28672) is 7.5 GB
    in f32.  Groups run along K inside each matrix, so quantizing matrix
    by matrix gives identical codes, scales and zero-points, with a
    temporary of one matrix in f32.
    """
    K, N = w.shape[-2:]
    if out is None:
        out = empty_stacked(w.shape, cfg, w.device)
    G = K // cfg.group_size
    codes = out.codes.view(-1, K, N)
    scales = out.scales.view(-1, G, N)
    zps = out.zero_points.view(-1, G, N)
    for j, m in enumerate(w.reshape(-1, K, N)):
        qt = amat_quantize(m, cfg)
        codes[j], scales[j], zps[j] = qt.codes, qt.scales, qt.zero_points
    return out


def truncate(qt: QuantizedTensor, *, low_bits: int, truncate_zp: bool = True,
             rescale: bool = True) -> QuantizedTensor:
    """Derive a low-bit QuantizedTensor from a high-bit one by truncation.

    ``truncate_zp=True, rescale=True``  -> AMAT (the paper's scheme).
    ``truncate_zp=False, rescale=False`` -> naive truncation baseline.
    """
    shift = qt.bits - low_bits
    if shift < 0:
        raise ValueError(f"cannot truncate {qt.bits}b -> {low_bits}b")
    if shift == 0:
        return qt
    if qt.asymmetric:
        codes = qt.codes >> shift
        zps = (qt.zero_points >> shift) if truncate_zp else qt.zero_points
    else:
        # arithmetic shift == floor division for int8
        codes = qt.codes.to(torch.int8) >> shift
        zps = qt.zero_points
    scales = qt.scales * (2.0 ** shift) if rescale else qt.scales
    return QuantizedTensor(codes, scales, zps, low_bits, qt.group_size,
                           qt.asymmetric)


def msb_slice(codes: torch.Tensor, shift: int) -> torch.Tensor:
    """Top ``bits - shift`` bits of each code (the low-precision payload)."""
    return codes >> shift


def lsb_slice(codes: torch.Tensor, shift: int) -> torch.Tensor:
    """Bottom ``shift`` bits of each code (the precision-upgrade payload)."""
    return codes & ((1 << shift) - 1)


def reconstruct(msb: torch.Tensor, lsb: torch.Tensor,
                shift: int) -> torch.Tensor:
    """Lossless high-bit code from its two slices."""
    return (msb << shift) | lsb


def dequant_high(qt: QuantizedTensor) -> torch.Tensor:
    """Full-precision path (MSB+LSB both resident)."""
    return dequantize(qt)


def dequant_low(qt: QuantizedTensor, cfg: MatConfig) -> torch.Tensor:
    """MSB-only path (AMAT truncation)."""
    return dequantize(truncate(qt, low_bits=cfg.low_bits))


def dequant_mixed(qt: QuantizedTensor, use_lsb: torch.Tensor,
                  shift: int) -> torch.Tensor:
    """Per-leading-index mixed dequantization.

    ``use_lsb`` has shape ``qt.codes.shape[:use_lsb.ndim]`` (typically
    ``(E,)``) and selects, per expert, the high-bit (MSB+LSB) or the AMAT
    low-bit (MSB-only) dequantization.
    """
    codes = qt.codes
    *lead, K, N = codes.shape
    G = K // qt.group_size
    cg = codes.reshape(*lead, G, qt.group_size, N).to(torch.float32)
    zp = qt.zero_points[..., :, None, :].to(torch.float32)
    s = qt.scales[..., :, None, :]

    w_hi = (cg - zp) * s
    cl = torch.floor(cg / (2.0 ** shift))
    zl = torch.floor(zp / (2.0 ** shift))
    w_lo = (cl - zl) * (s * (2.0 ** shift))

    sel = use_lsb.to(torch.bool).reshape(
        tuple(use_lsb.shape) + (1,) * (w_hi.ndim - use_lsb.ndim))
    return torch.where(sel, w_hi, w_lo).reshape(*lead, K, N)


def slice_nbytes(shape, bits: int, group_size: int, *, which: str,
                 shift: int) -> float:
    """Storage cost of one slice of a quantized weight of ``shape``.

    MSB slice carries the (bits - shift)-bit codes plus all group metadata
    (scale fp16 + truncated zp); the LSB slice is codes-only.
    """
    n = 1.0
    for s in shape:
        n *= float(s)
    n_groups = n / group_size
    if which == "msb":
        code_bits = bits - shift
        return n * code_bits / 8 + n_groups * (2 + code_bits / 8)
    if which == "lsb":
        return n * shift / 8
    raise ValueError(which)
