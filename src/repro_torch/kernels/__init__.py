"""Kernels written by hand for NVIDIA Hopper, one per ported TPU kernel.

Each kernel ships as ``ops.py`` (the public wrapper: checks, launch,
launch counter), ``ref.py`` (the plain PyTorch version the CPU path and
the on-card comparison use) and ``csrc/`` (the CUDA C++ source, built at
first use by :mod:`repro_torch.kernels._build`).

Subpackages:
  * :mod:`repro_torch.kernels.amat_matmul` — the batched-expert fused
    AMAT dequant-matmul (``wi`` K-major and ``wo`` output-major).
"""
