"""Plain PyTorch version of the absorbed-MLA decode kernel: the attention
of one multi-head latent attention layer of a decode step, after its
projections and the absorption of ``W_UK`` into the query.

For each sequence b at position ``pos[b]`` and each head h:

* ``q_pe`` and the new ``kpe`` row get RoPE at ``pos[b]``
  (:func:`layers.apply_rope_freqs` with the layer's frequencies and
  cos/sin scale);
* the new latent row ``ckv_new`` and the rotated ``kpe`` row are written
  into the caches at ``pos[b]`` (:func:`decode_attn.ref.write_row`:
  dropped at ``pos >= S``);
* ``s_j = (q_lat[b, h] . ckv[b, j] + q_pe[b, h] . kpe[b, j]) * scale``
  over the rows ``j < min(pos[b] + 1, S)``, softmax, and
  ``o_lat[b, h] = sum_j p_j ckv[b, j]``, in f32, rounded to q's dtype.

The caller lifts ``o_lat`` through ``W_UV``.  :func:`mla_attend` is the
attention alone.  The CPU path of
:func:`repro_torch.kernels.mla_decode.ops.mla_decode_fused` runs
:func:`mla_decode_fused_ref`, the model runs it for f32 models on the
card, and the card tests hold the kernel against it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.ref import write_row
from repro_torch.models import layers as L


def rope_at(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor,
            scale: float = 1.0) -> torch.Tensor:
    """x [B, n, D] rotated at each sequence's position ``pos`` ([B] or
    scalar), in x's dtype."""
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1)
    return L.apply_rope_freqs(x[:, None], positions, freqs, scale)[:, 0]


def mla_attend(q_lat: torch.Tensor, q_pe: torch.Tensor,
               ckv: torch.Tensor, kpe: torch.Tensor, cur,
               scale: float) -> torch.Tensor:
    """q_lat [B, H, R], q_pe [B, H, E] (rotated); caches ckv [B, S, R],
    kpe [B, S, E]; ``cur`` [] or [B] valid rows -> o_lat [B, H, R] in
    q_lat's dtype."""
    b, s, _ = ckv.shape
    ckv_f = ckv.to(torch.float32)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.to(torch.float32), ckv_f)
              + torch.einsum("bhe,bse->bhs", q_pe.to(torch.float32),
                             kpe.to(torch.float32))) * scale
    cur = torch.as_tensor(cur, device=ckv.device)
    cur_b = cur.reshape(-1).expand(b) if cur.ndim == 0 else cur
    valid = torch.arange(s, device=ckv.device)[None, :] < cur_b[:, None]
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, ckv_f).to(q_lat.dtype)


def mla_decode_fused_ref(q_lat: torch.Tensor, q_pe: torch.Tensor,
                         ckv_new: torch.Tensor, kpe_new: torch.Tensor,
                         ckv_cache: torch.Tensor, kpe_cache: torch.Tensor,
                         pos: torch.Tensor, freqs: torch.Tensor, *,
                         scale: float, rope_scale: float = 1.0
                         ) -> torch.Tensor:
    """q_lat [B, H, R]; q_pe [B, H, E] before RoPE; the new rows ckv_new
    [B, R] and kpe_new [B, E] (before RoPE); caches [B, S, R] and [B, S,
    E], written in place; ``pos`` [B] or scalar -> o_lat [B, H, R]."""
    q_pe = rope_at(q_pe, pos, freqs, rope_scale)
    k_pe = rope_at(kpe_new[:, None], pos, freqs, rope_scale)[:, 0]
    write_row(ckv_cache, ckv_new, pos)
    write_row(kpe_cache, k_pe, pos)
    return mla_attend(q_lat, q_pe, ckv_cache, kpe_cache, pos + 1, scale)
