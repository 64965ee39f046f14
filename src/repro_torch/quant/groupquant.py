"""Group quantization primitives (port of ``repro.quant.groupquant``).

Conventions (identical to the reference):

* ``w`` has shape ``(..., K, N)``; groups tile K: ``K = G * group_size``.
* Asymmetric: ``q = clip(round(w / s) + zp, 0, 2^b - 1)``;
  ``dequant = (q - zp) * s`` with integer zero-point ``zp`` (uint domain).
* Symmetric:  ``q = clip(round(w / s), -2^(b-1), 2^(b-1) - 1)``;
  ``dequant = q * s``.
* Codes are stored in ``uint8``/``int8`` whatever the logical width.

The scale is computed in f32 as the reference's compiled code computes
it: XLA turns ``range / qmax`` (a division by a constant) into a multiply
by the f32 reciprocal ``range * (1 / qmax)``, which differs from the
quotient by one ulp in about 70% of groups, so the port writes the
multiply.  The divisions by the scale stay true divisions on both sides,
and ``torch.round`` rounds half to even like ``jnp.round``, so codes,
zero-points and scales equal the reference's exactly on identical f32
input.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    bits: int
    group_size: int
    asymmetric: bool


@dataclasses.dataclass
class QuantizedTensor:
    """Group-quantized tensor.

    Attributes:
      codes:  integer codes, ``uint8`` (asym) or ``int8`` (sym), shape
              ``(..., K, N)``.
      scales: per-group f32 scales, shape ``(..., K // group_size, N)``.
      zero_points: per-group ``uint8`` zero-points, same shape as
              ``scales``; all-zero for symmetric quantization.
      bits / group_size / asymmetric: static metadata.
    """

    codes: torch.Tensor
    scales: torch.Tensor
    zero_points: torch.Tensor
    bits: int
    group_size: int
    asymmetric: bool

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def nbytes_weights(self) -> float:
        """Logical storage in bytes at the *logical* bit-width."""
        n_codes = float(self.codes.numel())
        n_groups = float(self.scales.numel())
        # fp16 scale + b-bit zero point per group
        return n_codes * self.bits / 8 + n_groups * (2 + self.bits / 8)

    def index(self, i: int) -> "QuantizedTensor":
        """The tensor's ``i``-th leading slice (a view, no copy)."""
        return QuantizedTensor(self.codes[i], self.scales[i],
                               self.zero_points[i], self.bits,
                               self.group_size, self.asymmetric)

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


def _group_reshape(w: torch.Tensor, group_size: int) -> torch.Tensor:
    *lead, K, N = w.shape
    if K % group_size != 0:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    return w.reshape(*lead, K // group_size, group_size, N)


@torch.no_grad()
def quantize(w: torch.Tensor, *, bits: int = 8, group_size: int = 32,
             asymmetric: bool = True) -> QuantizedTensor:
    """Group-quantize ``w`` along its second-to-last dimension.

    Works in place on one f32 copy of ``w`` (the reference's temporaries
    are separate arrays), so the peak is about twice ``w`` in f32.
    """
    wg = _group_reshape(w.to(torch.float32), group_size)
    if wg.data_ptr() == w.data_ptr():
        wg = wg.clone()
    if asymmetric:
        qmax = 2 ** bits - 1
        wmin = torch.clamp_max(torch.amin(wg, dim=-2, keepdim=True), 0.0)
        wmax = torch.clamp_min(torch.amax(wg, dim=-2, keepdim=True), 0.0)
        scale = (wmax - wmin) * (1.0 / qmax)
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        zp = torch.clamp(torch.round(-wmin / scale), 0, qmax)
        q = wg.div_(scale).round_().add_(zp).clamp_(0, qmax)
        codes = q.to(torch.uint8).reshape(w.shape)
        scales = scale.squeeze(-2).to(torch.float32)
        zps = zp.squeeze(-2).to(torch.uint8)
    else:
        qmax = 2 ** (bits - 1) - 1
        amax = torch.amax(wg.abs(), dim=-2, keepdim=True)
        scale = amax * (1.0 / qmax)
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        q = wg.div_(scale).round_().clamp_(-(qmax + 1), qmax)
        codes = q.to(torch.int8).reshape(w.shape)
        scales = scale.squeeze(-2).to(torch.float32)
        zps = torch.zeros(scales.shape, dtype=torch.uint8,
                          device=scales.device)
    return QuantizedTensor(codes, scales, zps, bits, group_size, asymmetric)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    codes = qt.codes
    *lead, K, N = codes.shape
    G = K // qt.group_size
    cg = codes.reshape(*lead, G, qt.group_size, N).to(torch.float32)
    scales = qt.scales[..., :, None, :]
    if qt.asymmetric:
        zps = qt.zero_points[..., :, None, :].to(torch.float32)
        w = (cg - zps) * scales
    else:
        w = cg * scales
    return w.reshape(*lead, K, N)


def quantization_error(w: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Relative RMS error of a quantized tensor vs the original (a 0-d
    f32 tensor)."""
    d = dequantize(qt) - w.to(torch.float32)
    return torch.sqrt(torch.mean(d * d)) / (torch.sqrt(torch.mean(w * w))
                                            + 1e-12)
