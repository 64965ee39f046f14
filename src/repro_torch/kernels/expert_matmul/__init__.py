"""Batched per-expert sliced dequant matmul (DBSC), on Hopper.

:func:`expert_matmul` / :func:`expert_matmul_qt` compute the expert FFN
matmul of an ``[E, C, K]`` dispatch buffer on AMAT codes, expert ``e`` at
high precision (MSB+LSB) iff ``use_lsb[e]``.  The CUDA kernel is the
K-major body of :mod:`repro_torch.kernels.amat_matmul` under an entry of
its own.
"""

from repro_torch.kernels.expert_matmul.ops import (LAUNCHES, expert_matmul,
                                                   expert_matmul_qt)

__all__ = ["LAUNCHES", "expert_matmul", "expert_matmul_qt"]
