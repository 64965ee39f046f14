"""Plain PyTorch versions of the fused AMAT dequant-matmuls.

Port of ``repro/kernels/amat_matmul/ref.py``.  The CPU paths of
:mod:`repro_torch.kernels.amat_matmul.ops` run these, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.  Per
expert ``e`` of the batched version::

    W_e = (c - z) * s                                   if use_lsb[e]
    W_e = (floor(c / 2^shift) - floor(z / 2^shift)) * s * 2^shift   else
    out[e] = x[e] @ W_e                                 (f32)

The single-matrix :func:`amat_matmul_ref` takes the precision as a static
``mode``: ``'high'`` is the first line, ``'low'`` the second.
"""

from __future__ import annotations

import torch


def amat_matmul_ref(x, codes, scales, zps, *, group_size: int = 32,
                    shift: int = 0, mode: str = "high"):
    """x: [M, K] float; codes: [K, N] uint8; scales/zps: [K//G, N].
    Returns [M, N] f32."""
    K, N = codes.shape
    G = K // group_size
    c = codes.reshape(G, group_size, N).to(torch.float32)
    z = zps.reshape(G, 1, N).to(torch.float32)
    s = scales.reshape(G, 1, N).to(torch.float32)
    if mode == "low" and shift > 0:
        c = torch.floor(c / (2.0 ** shift))
        z = torch.floor(z / (2.0 ** shift))
        s = s * (2.0 ** shift)
    w = ((c - z) * s).reshape(K, N)
    return x.to(torch.float32) @ w


def _dequant_mixed_ref(codes, scales, zps, use_lsb, *, group_size, shift):
    """[E, K, N] codes -> [E, K, N] f32 weights, per-expert precision."""
    E, K, N = codes.shape
    G = K // group_size
    c = codes.reshape(E, G, group_size, N).to(torch.float32)
    z = zps.reshape(E, G, 1, N).to(torch.float32)
    s = scales.reshape(E, G, 1, N).to(torch.float32)
    w_hi = (c - z) * s
    w_lo = (torch.floor(c / (2.0 ** shift)) - torch.floor(z / (2.0 ** shift))) \
        * (s * (2.0 ** shift))
    sel = use_lsb.reshape(E, 1, 1, 1).to(torch.bool)
    return torch.where(sel, w_hi, w_lo).reshape(E, K, N)


def amat_batched_matmul_ref(x, codes, scales, zps, use_lsb, *,
                            group_size: int = 32, shift: int = 4):
    """x: [E, M, K]; codes: [E, K, N]; scales/zps: [E, K//G, N];
    use_lsb: [E] bool.  Returns [E, M, N] f32."""
    w = _dequant_mixed_ref(codes, scales, zps, use_lsb,
                           group_size=group_size, shift=shift)
    return torch.bmm(x.to(torch.float32), w)


def amat_batched_matmul_t_ref(x, codes_t, scales, zps, use_lsb, *,
                              group_size: int = 32, shift: int = 4):
    """Transposed-weight version: codes_t [E, N, K], metadata [E, K//G, N]."""
    return amat_batched_matmul_ref(x, codes_t.transpose(-1, -2), scales, zps,
                                   use_lsb, group_size=group_size,
                                   shift=shift)
