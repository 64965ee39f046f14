"""Transformer building blocks (port of the parts of ``repro.models.layers``
that the ``moe`` architecture runs).

RMSNorm, RoPE, causal GQA attention over a full sequence, single-token
decode attention against a KV cache, and the SwiGLU MLP.  Attention
scores, softmax and the value mix run in f32 as in the reference.  Not
ported yet (ROADMAP.md queue 1): blockwise attention above 8192 keys
(``BLOCKWISE_THRESHOLD``; longer key sequences raise), sliding windows,
logit soft-capping and the other MLP types ('remaining architectures').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCKWISE_THRESHOLD = 8192


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*rep, D] by repeat (GQA)."""
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool) -> torch.Tensor:
    """Multi-head attention.  q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D]."""
    if k.shape[1] > BLOCKWISE_THRESHOLD:
        raise NotImplementedError(
            "blockwise attention above 8192 keys is not ported yet "
            "(ROADMAP.md queue 1, 'blockwise_attention')")
    rep = q.shape[2] // k.shape[2]
    k = _expand_kv(k, rep)
    v = _expand_kv(v, rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale

    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos) -> torch.Tensor:
    """Single-token attention.  q: [B, H, D]; caches [B, S, Hkv, D];
    ``cur_pos``: [] or [B] number of valid cache entries."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[1]
    rep = h // hkv
    scale = d ** -0.5
    qf = q.to(torch.float32).reshape(b, hkv, rep, d)
    kf = k_cache.to(torch.float32)
    scores = torch.einsum("bgrd,bsgd->bgrs", qf, kf) * scale
    kpos = torch.arange(s, device=q.device)
    cur = torch.as_tensor(cur_pos, device=q.device)
    cur_b = cur.reshape(-1).expand(b) if cur.ndim == 0 else cur
    valid = kpos[None, :] < cur_b[:, None]                  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def swiglu(h: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU on the fused gate|up projection ``h`` [..., 2F]: the gate's
    SiLU in f32, cast to ``dtype``, times the up half."""
    g, u = torch.chunk(h, 2, dim=-1)
    return F.silu(g.to(torch.float32)).to(dtype) * u


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """Dense FFN. params: {'wi': [d, 2F], 'wo': [F, d]} (SwiGLU)."""
    if mlp_type != "swiglu":
        raise NotImplementedError(
            f"mlp_type {mlp_type!r} is not ported yet (ROADMAP.md queue 1, "
            "'remaining architectures')")
    return swiglu(x @ params["wi"], x.dtype) @ params["wo"]


def mlp_param_shapes(d_model: int, d_ff: int, mlp_type: str) -> dict:
    wi_cols = 2 * d_ff if mlp_type in ("swiglu", "geglu") else d_ff
    return {"wi": (d_model, wi_cols), "wo": (d_ff, d_model)}
