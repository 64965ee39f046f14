"""Public wrapper of the per-expert sliced dequant matmul.

:func:`expert_matmul` keeps the semantics of the reference wrapper
(``repro/kernels/expert_matmul/ops.py``): ``[E, C, K] @
per-expert-dequant([E, K, N] codes) -> [E, C, N] f32``.

* On CUDA tensors it launches the hand-written Hopper kernel of
  ``amat_matmul/csrc/amat_batched_matmul.cu`` on K-major codes (the
  reference computes the batched AMAT function) through
  :func:`repro_torch.kernels.amat_matmul.ops.launch`, which checks the
  operands, pads a ragged N and raises on a failed launch, and adds one
  to :data:`LAUNCHES`.
* On CPU tensors it runs the plain PyTorch version in :mod:`.ref`.
"""

from __future__ import annotations

from repro_torch.kernels._build import LaunchCounter
from repro_torch.kernels.amat_matmul import ops as amat_ops
from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref

LAUNCHES = LaunchCounter("expert")


def expert_matmul(x, codes, scales, zps, use_lsb, *, group_size: int = 32,
                  shift: int = 4):
    """[E, C, K] x [E, K, N] (AMAT codes, per-expert precision) -> [E, C, N]
    f32.  ``use_lsb`` [E] selects MSB+LSB (True) or MSB-only dequant at
    ``shift`` per expert; scales / zps are ``[E, K // group_size, N]``."""
    if x.device.type == "cuda":
        return amat_ops.launch("expert_matmul", LAUNCHES, "expert", x, codes,
                               scales, zps, use_lsb, group_size=group_size,
                               shift=shift)
    if x.device.type == "cpu":
        return expert_matmul_ref(x, codes, scales, zps, use_lsb,
                                 group_size=group_size, shift=shift)
    raise ValueError(f"expert_matmul: no path for device {x.device}")


def expert_matmul_qt(x, qt, use_lsb, *, shift: int):
    """QuantizedTensor convention for :func:`expert_matmul`."""
    if not qt.asymmetric:
        raise ValueError("AMAT kernel expects asymmetric group quant")
    return expert_matmul(x, qt.codes, qt.scales, qt.zero_points, use_lsb,
                         group_size=qt.group_size, shift=shift)
