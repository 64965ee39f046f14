"""Transformer building blocks (port of ``repro.models.layers``).

RMSNorm and LayerNorm, RoPE, GQA attention over a full sequence (dense up
to ``BLOCKWISE_THRESHOLD`` keys, online-softmax over ``BLOCK_KV``-key
blocks above it) with an optional sliding window and logit soft-capping,
single-token decode attention against a KV cache (the same window and
soft-cap), and the four MLPs: SwiGLU (llama family), GeGLU (gemma),
squared ReLU (nemotron) and GELU (starcoder2).  Scores, softmax and the
value mix run in f32 as in the reference; the GELUs are the reference's
tanh approximation.  The encoder's self-attention and the decoder's
cross-attention are ``attention`` with ``causal=False``
(``models/model.py``).

Multi-head latent attention (DeepSeek-V2) adds YaRN's RoPE frequencies
(:func:`yarn_frequencies`) and mscale (:func:`yarn_mscale`), the MLA
settings' frequencies, cos/sin scale and softmax scale (:func:`mla_rope`,
:func:`mla_softmax_scale`), and :func:`attention`'s ``scale`` for a
softmax scale other than the head dim's and a value head narrower than
the query's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

BLOCKWISE_THRESHOLD = 8192
BLOCK_KV = 1024


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale for a context ``factor`` times longer."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_frequencies(dim: int, theta: float, factor: float,
                     original_max: int, beta_fast: float, beta_slow: float,
                     device=None) -> torch.Tensor:
    """YaRN's RoPE frequencies [dim/2]: each plain frequency ``e_i``,
    its interpolation ``e_i / factor``, and between them a linear ramp
    over the dims from the one that turns ``beta_fast`` times in
    ``original_max`` positions (kept as ``e_i``) to the one that turns
    ``beta_slow`` times (interpolated)."""
    e = rope_frequencies(dim, theta, device)

    def corr_dim(rotations: float) -> float:
        return dim * math.log(original_max / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return e / factor * ramp + e * (1.0 - ramp)


def mla_rope(mla, theta: float, device=None):
    """(frequencies [qk_rope_head_dim / 2], cos/sin scale) of an
    ``MLACfg``'s RoPE dims: YaRN's where ``rope_factor`` > 1."""
    d = mla.qk_rope_head_dim
    if mla.rope_factor <= 1:
        return rope_frequencies(d, theta, device), 1.0
    freqs = yarn_frequencies(d, theta, mla.rope_factor,
                             mla.rope_original_max, mla.beta_fast,
                             mla.beta_slow, device)
    scale = yarn_mscale(mla.rope_factor, mla.mscale) \
        / yarn_mscale(mla.rope_factor, mla.mscale_all_dim)
    return freqs, scale


def mla_softmax_scale(mla) -> float:
    """``qk_head_dim ** -0.5``, times YaRN's mscale squared."""
    m = yarn_mscale(mla.rope_factor, mla.mscale_all_dim) \
        if mla.mscale_all_dim else 1.0
    return mla.qk_head_dim ** -0.5 * m * m


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    return apply_rope_freqs(x, positions,
                            rope_frequencies(x.shape[-1], theta, x.device))


def apply_rope_freqs(x: torch.Tensor, positions: torch.Tensor,
                     freqs: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """:func:`apply_rope` with the frequencies [D/2] given, and cos and sin
    times ``scale`` (YaRN's) where it is not 1: each half of the last dim
    rotated with the other, in f32, rounded to x's dtype."""
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int

    @property
    def q_rep(self) -> int:
        return self.n_heads // self.n_kv_heads


def _expand_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*rep, D] by repeat (GQA)."""
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _soft_cap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: Union[int, torch.Tensor] = 0,
              sliding_window: Optional[int] = None,
              logit_softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention.  q/k: [B, Sq|Sk, H|Hkv, D]; v: [B, Sk, Hkv,
    Dv] (Dv may differ from D); ``scale`` defaults to ``D ** -0.5``.
    Dispatches to :func:`blockwise_attention` above the threshold."""
    if k.shape[1] > BLOCKWISE_THRESHOLD:
        return blockwise_attention(
            q, k, v, causal=causal, q_offset=q_offset,
            sliding_window=sliding_window, logit_softcap=logit_softcap,
            scale=scale)
    return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                           sliding_window=sliding_window,
                           logit_softcap=logit_softcap, scale=scale)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: Union[int, torch.Tensor] = 0,
                    sliding_window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The dense body of :func:`attention`: the full (Sq x Sk) score
    matrix per head, masked and softmaxed in f32, at any length."""
    rep = q.shape[2] // k.shape[2]
    k = _expand_kv(k, rep)
    v = _expand_kv(v, rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = _soft_cap(scores, logit_softcap)

    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if sliding_window is not None:
        mask &= qpos[:, None] - kpos[None, :] < sliding_window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool,
                        q_offset: Union[int, torch.Tensor] = 0,
                        sliding_window: Optional[int] = None,
                        logit_softcap: Optional[float] = None,
                        block_kv: int = BLOCK_KV,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over ``block_kv``-key blocks.

    Never materializes the (Sq x Sk) score matrix: peak memory is
    (Sq x block_kv) per head.  The keys are zero-padded to a multiple of
    ``block_kv`` and the padding masked; a Python loop over the blocks
    carries the running max ``m``, normalizer ``l`` and accumulator, as
    the reference's ``lax.scan`` does.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    pad = (-sk) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = (sk + pad) // block_kv
    if scale is None:
        scale = d ** -0.5
    qf = q.to(torch.float32)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for blk in range(n_blocks):
        sl = slice(blk * block_kv, (blk + 1) * block_kv)
        kblk = _expand_kv(k[:, sl], rep).to(torch.float32)
        vblk = _expand_kv(v[:, sl], rep).to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk) * scale
        s = _soft_cap(s, logit_softcap)
        kpos = blk * block_kv + torch.arange(block_kv, device=q.device)
        mask = (kpos[None, :] < sk).expand(sq, block_kv)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if sliding_window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < sliding_window)
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # [B, Sq, H, D]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos, *,
                     sliding_window: Optional[int] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention.  q: [B, H, D]; caches [B, S, Hkv, D];
    ``cur_pos``: [] or [B] number of valid cache entries; a
    ``sliding_window`` keeps the last ``sliding_window`` of them."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[1]
    rep = h // hkv
    scale = d ** -0.5
    qf = q.to(torch.float32).reshape(b, hkv, rep, d)
    kf = k_cache.to(torch.float32)
    scores = torch.einsum("bgrd,bsgd->bgrs", qf, kf) * scale
    scores = _soft_cap(scores, logit_softcap)
    kpos = torch.arange(s, device=q.device)
    cur = torch.as_tensor(cur_pos, device=q.device)
    cur_b = cur.reshape(-1).expand(b) if cur.ndim == 0 else cur
    valid = kpos[None, :] < cur_b[:, None]                  # [B, S]
    if sliding_window is not None:
        valid &= kpos[None, :] >= (cur_b[:, None] - sliding_window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def ffn_activation(h: torch.Tensor, mlp_type: str, dtype) -> torch.Tensor:
    """The FFN nonlinearity on the ``wi`` output ``h``, in f32, cast to
    ``dtype``: for the gated types (``swiglu``, ``geglu``) on the gate
    half of ``h`` [..., 2F], times the up half; for ``relu2`` and
    ``gelu`` on ``h`` [..., F].  GELU is the tanh approximation, as the
    reference's ``jax.nn.gelu(approximate=True)``."""
    if mlp_type in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        g = g.to(torch.float32)
        a = F.silu(g) if mlp_type == "swiglu" \
            else F.gelu(g, approximate="tanh")
        return a.to(dtype) * u
    if mlp_type == "relu2":
        return torch.square(F.relu(h.to(torch.float32))).to(dtype)
    if mlp_type == "gelu":
        return F.gelu(h.to(torch.float32), approximate="tanh").to(dtype)
    raise ValueError(f"unknown mlp_type {mlp_type}")


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """Dense FFN. params: {'wi': [d, F] or [d, 2F] for gated, 'wo': [F, d]}."""
    return ffn_activation(x @ params["wi"], mlp_type, x.dtype) @ params["wo"]


def mlp_param_shapes(d_model: int, d_ff: int, mlp_type: str) -> dict:
    wi_cols = 2 * d_ff if mlp_type in ("swiglu", "geglu") else d_ff
    return {"wi": (d_model, wi_cols), "wo": (d_ff, d_model)}
