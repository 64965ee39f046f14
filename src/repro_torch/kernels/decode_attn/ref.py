"""Plain PyTorch version of the decode-attention kernel: one attention
layer of a decode step after its q/k/v projections.

:func:`decode_attention_fused_ref` is the plain route of
:func:`repro_torch.models.model._attn_decode`: RoPE on q and the new k
(:func:`layers.apply_rope`), the new K and V rows written at each
sequence's position (:func:`write_row`; at ``pos % S`` in a ring, as int8
codes and their scales in an int8 cache), the rows to attend selected
(:func:`attend_rows`) and attention over them (:func:`layers.decode_attention`,
or the kernel's attend-only wrapper that the model passes on the card for
a ring or int8 cache).  The CPU path of
:func:`repro_torch.kernels.decode_attn.ops.decode_attention_fused` runs it,
the model runs it for f32 caches on the card, and the card tests hold the
kernel against it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.models import layers as L


def write_row(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor, *,
              ring: bool = False) -> torch.Tensor:
    """Write each sequence's new row ``val`` [B, ...] into ``buf`` [B, S,
    ...] in place at its position ``pos`` ([B] or scalar), at ``pos % S``
    in a ring; returns ``buf``."""
    b, s = buf.shape[:2]
    val = val.to(buf.dtype)
    at = pos % s if ring else pos
    if pos.ndim == 0:
        buf[:, at.reshape(1)] = val[:, None]
        return buf
    rows = torch.arange(b, device=buf.device)
    if ring:
        buf[rows, at] = val
        return buf
    # A row at or past the cache's end (an idle slot's position keeps
    # counting) is dropped, as the reference's scatter drops it; no host
    # sync.
    at = pos.clamp(max=s - 1)
    keep = (pos < s).reshape((b,) + (1,) * (buf.ndim - 2))
    buf[rows, at] = torch.where(keep, val, buf[rows, at])
    return buf


def attend_rows(bufs: List[torch.Tensor], pos: torch.Tensor,
                window: Optional[int], *, ring: bool = False):
    """The cache rows a decode step attends over after writing row ``pos``:
    ``(bufs, cur, window)`` for :func:`layers.decode_attention`.

    A ring buffer holds only rows within the window: attend over every
    resident row (attention is permutation-invariant, so the wrap's order
    does not matter).  Otherwise a windowed step at aligned positions reads
    only the last ``window`` cache rows (O(window) traffic, not a masked
    full read); per-sequence positions read the full cache and let the
    per-row mask bound each window."""
    s_cache = bufs[0].shape[1]
    if ring:
        return bufs, torch.clamp(pos + 1, max=s_cache), None
    if pos.ndim == 0 and window is not None and s_cache > window:
        start = torch.clamp(pos + 1 - window, 0, s_cache - window)
        idx = start + torch.arange(window, device=pos.device)
        return [t.index_select(1, idx) for t in bufs], pos + 1 - start, None
    return bufs, pos + 1, window


class Int8KV(NamedTuple):
    """An int8 KV cache's per-(row, head) scales [B, S, Hkv], written in
    place beside its codes, and its codec: ``quant(x) -> (codes, scales)``
    and ``dequant(codes, scales) -> rows`` in the model's dtype."""
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    quant: Callable
    dequant: Callable


def decode_attention_fused_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: torch.Tensor,
                               theta: float, *,
                               sliding_window: Optional[int] = None,
                               logit_softcap: Optional[float] = None,
                               ring: bool = False,
                               int8: Optional[Int8KV] = None,
                               attend: Callable = L.decode_attention
                               ) -> torch.Tensor:
    """q [B, H, D]; the new rows k, v [B, Hkv, D]; caches [B, S, Hkv, D],
    written in place; ``pos`` [B] or scalar -> [B, H, D] in q's dtype.
    ``ring``: a ring cache; ``int8``: the caches hold int8 codes;
    ``attend``: the attention over the selected rows, with the signature
    of :func:`layers.decode_attention`."""
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1)
    q = L.apply_rope(q[:, None], positions, theta)[:, 0]
    k = L.apply_rope(k[:, None], positions, theta)[:, 0]
    writes = [(k_cache, k), (v_cache, v)]
    if int8 is not None:
        (kq, ks), (vq, vs) = int8.quant(k), int8.quant(v)
        writes = [(k_cache, kq), (v_cache, vq), (int8.k_scale, ks),
                  (int8.v_scale, vs)]
    bufs = [write_row(buf, val, pos, ring=ring) for buf, val in writes]
    bufs, cur, window = attend_rows(bufs, pos, sliding_window, ring=ring)
    kc, vc = bufs[:2]
    if int8 is not None:
        kc, vc = int8.dequant(kc, bufs[2]), int8.dequant(vc, bufs[3])
    return attend(q, kc, vc, cur, sliding_window=window,
                  logit_softcap=logit_softcap)
