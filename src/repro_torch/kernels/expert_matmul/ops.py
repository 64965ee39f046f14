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

It takes the reference's tile keywords ``bm``, ``bn``, ``bk``, which
choose no tile (the launch path chooses it from the shapes), and
``interpret``, which chooses the route
(:func:`repro_torch.kernels._build.launches_kernel`).
"""

from __future__ import annotations

from repro_torch.kernels._build import LaunchCounter, launches_kernel
from repro_torch.kernels.amat_matmul import ops as amat_ops
from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref

LAUNCHES = LaunchCounter("expert")


def expert_matmul(x, codes, scales, zps, use_lsb, *, group_size: int = 32,
                  shift: int = 4, bm: int = 128, bn: int = 128,
                  bk: int = 128, interpret=None):
    """[E, C, K] x [E, K, N] (AMAT codes, per-expert precision) -> [E, C, N]
    f32.  ``use_lsb`` [E] selects MSB+LSB (True) or MSB-only dequant at
    ``shift`` per expert; scales / zps are ``[E, K // group_size, N]``."""
    if launches_kernel("expert_matmul", x, interpret):
        return amat_ops.launch("expert_matmul", LAUNCHES, "expert", x, codes,
                               scales, zps, use_lsb, group_size=group_size,
                               shift=shift)
    return expert_matmul_ref(x, codes, scales, zps, use_lsb,
                             group_size=group_size, shift=shift)


def expert_matmul_qt(x, qt, use_lsb, *, shift: int, **kw):
    """QuantizedTensor convention for :func:`expert_matmul`; ``kw`` goes
    to it."""
    if not qt.asymmetric:
        raise ValueError("AMAT kernel expects asymmetric group quant")
    return expert_matmul(x, qt.codes, qt.scales, qt.zero_points, use_lsb,
                         group_size=qt.group_size, shift=shift, **kw)
