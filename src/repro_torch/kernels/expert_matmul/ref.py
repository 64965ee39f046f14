"""Plain PyTorch version of the per-expert sliced dequant matmul.

Port of ``repro/kernels/expert_matmul/ref.py``: batched over experts,
``y[e] = x[e] @ dequant_e(codes[e])`` where expert ``e`` dequantizes at
high precision (MSB+LSB) iff ``use_lsb[e]``, the DBSC mixed-precision
expert FFN (paper §4.1).  The CPU path of
:func:`repro_torch.kernels.expert_matmul.ops.expert_matmul` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch


def expert_matmul_ref(x, codes, scales, zps, use_lsb, *,
                      group_size: int = 32, shift: int = 4):
    """x: [E, C, K]; codes: [E, K, N]; scales/zps: [E, K//G, N];
    use_lsb: [E] bool.  Returns [E, C, N] f32."""
    E, K, N = codes.shape
    G = K // group_size
    c = codes.reshape(E, G, group_size, N).to(torch.float32)
    z = zps.reshape(E, G, 1, N).to(torch.float32)
    s = scales.reshape(E, G, 1, N).to(torch.float32)

    w_hi = (c - z) * s
    c_lo = torch.floor(c / (2.0 ** shift))
    z_lo = torch.floor(z / (2.0 ** shift))
    w_lo = (c_lo - z_lo) * (s * (2.0 ** shift))

    sel = use_lsb.reshape(E, 1, 1, 1).to(torch.bool)
    w = torch.where(sel, w_hi, w_lo).reshape(E, K, N)
    return torch.bmm(x.to(torch.float32), w)
