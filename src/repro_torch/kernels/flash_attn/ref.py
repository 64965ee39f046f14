"""Plain PyTorch version of the flash-attention kernel (causal, GQA,
optional sliding window).

Port of ``repro/kernels/flash_attn/ref.py``.  The CPU path of
:func:`repro_torch.kernels.flash_attn.ops.flash_attention` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  It works
through the query rows :data:`Q_CHUNK` at a time, so that the full-width
shapes fit on the card (each row's softmax is independent: the same
function).

Rows with no visible key (with a window, ``q - (Sk - 1) >= window``) are
outside the contract: this version averages ``v`` over all Sk keys there,
while the reference kernel's value depends on its tiling.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
Q_CHUNK = 1024


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window=None):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, H, D] f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    kpos = torch.arange(sk, device=q.device)
    out = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, sq)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1].to(torch.float32),
                         kf) * (d ** -0.5)
        qpos = torch.arange(q0, q1, device=q.device)
        mask = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if sliding_window is not None:
            mask &= qpos[:, None] - kpos[None, :] < sliding_window
        p = s.masked_fill_(~mask, NEG_INF)
        p = p.sub_(p.amax(-1, keepdim=True)).exp_()
        p = p.div_(p.sum(-1, keepdim=True))
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        del s, p
    return out
