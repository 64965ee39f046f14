"""Fused AMAT group-dequant matmuls (Hopper CUDA kernel).

:func:`amat_expert_matmul` / :func:`amat_expert_matmul_t` are the
quantized-execution path of the expert FFN: packed uint8 codes are
dequantized on chip inside the matmul's K loop with per-expert
high/low-bit selection, so dense expert weights never exist in device
memory.  :func:`amat_matmul` / :func:`amat_matmul_qt` run the same body on
one matrix at a static precision.
"""

from repro_torch.kernels.amat_matmul.ops import (LAUNCHES, amat_expert_matmul,
                                                 amat_expert_matmul_qt,
                                                 amat_expert_matmul_t,
                                                 amat_matmul, amat_matmul_qt)

__all__ = ["LAUNCHES", "amat_expert_matmul", "amat_expert_matmul_qt",
           "amat_expert_matmul_t", "amat_matmul", "amat_matmul_qt"]
