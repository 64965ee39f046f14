"""Model module ``deepseek_v2``: DeepSeek-V2-Lite's stack of layers, as
the published ``modeling_deepseek.py`` computes it.

The configuration file holds the published config's keys as they are
(``num_hidden_layers``, ``first_k_dense_replace``, ``kv_lora_rank``,
``rope_scaling`` ...), which this module reads, beside the keys the
shared harness reads (``d_model``, ``vocab_size``, ``norm_eps``,
``dtype``, ``moe``).  The stack: ``first_k_dense_replace`` leading layers
of multi-head latent attention (MLA) and a dense SwiGLU FFN of
``intermediate_size``, then the MoE layers, each MLA and the shared MoE
layer (``portbench/lib/reference.py``: softmax router, top-k, the shared
experts as one SwiGLU MLP beside the routed ones).

MLA without a query LoRA, per layer, on the normed input h (RMSNorm
``x * rsqrt(mean(x^2) + eps) * (1 + w)`` as everywhere in the harness):
``q = h W_q`` as [H, nope + rope]; ``c = h W_kva`` as [R | rope];
``c_kv = rms(c[:R])``; ``k_pe = rope(c[R:])``, one key shared by every
head; ``q_pe = rope(q[nope:])``; ``[k_nope | v] = c_kv W_kvb`` as [H,
nope + v]; ``score = (q_nope . k_nope + q_pe . k_pe) * sigma`` with a
causal softmax; ``out = x + concat_h(sum p v) W_o``.  RoPE rotates each
half of the rope dims with the other (the published code rotates
interleaved pairs: the same model up to a fixed permutation of the rope
output columns of ``W_q`` and ``W_kva``), at YaRN's frequencies: ``e_i =
theta^(-2i/d)``, ``f_i = e_i / factor``, a linear ramp ``r_i`` from the dim
that turns ``beta_fast`` times in ``original_max_position_embeddings``
positions to the one that turns ``beta_slow`` times, ``inv_freq_i = f_i
r_i + e_i (1 - r_i)``, and cos/sin times ``m(mscale) / m(mscale_all_dim)``
with ``m(s) = 0.1 s ln(factor) + 1``.  ``sigma = (nope + rope)^-0.5 *
m(mscale_all_dim)^2``.  Attention runs in blocks of query rows, so that a
request of 12,288 tokens fits.  The reference computes this
non-absorbed form in float32; the program decodes in the absorbed one.

The weight tree is the program's input format: ``embed``, ``unembed``,
``final_norm``, ``lead`` (the leading layers' leaves, stacked over them)
and ``blocks/pos0`` (the MoE layers' leaves, stacked over them); the
routing records are ``[MoE layers, 1, ...]``.  The leading layers' vectors
are zero, as every other vector of the draw.

``layer_work`` counts the absorbed decode's terms per token: the products
of ``W_q``, ``W_kva``, ``W_UK`` and ``W_UV`` (the halves of ``W_kvb``),
``W_o``, the dense FFN, the routers and the shared experts; attention
``2 H (R + rope + R)`` operations and ``R + rope`` bf16 values a cached
row and layer.  ``counts.prefill_work`` reads the same terms; the prefill
runs the non-absorbed form, whose terms differ, and no cell reads a
prefill metric.

:func:`plain_logits` is the same stack with plain top-k routing and the
float experts (no AMAT, no capacity), for the tests.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from portbench.lib import weights as W
from portbench.lib.counts import BF16, LayerWork
from portbench.lib.reference import (F32, RefRequest, _mm, _moe, _rms,
                                     _swiglu, no_tf32, top_k)

Q_BLOCK = 512


# ------------------------------------------------------------------ layout
def n_lead(cfg: dict) -> int:
    return cfg["first_k_dense_replace"]


def n_moe(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - n_lead(cfg)


def moe_layout(cfg: dict) -> tuple:
    """(MoE layers, 1): the program's records are [periods, MoE positions
    of its one-position pattern]."""
    return (n_moe(cfg), 1)


def _dims(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import BlockSpec, MLACfg, ModelConfig
    from repro_torch.models.moe import MoECfg

    d, H, R, dn, dr, dv = _dims(cfg)
    rs = cfg["rope_scaling"]
    return ModelConfig(
        name=cfg["name"], arch_type="moe",
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=H, head_dim=dn + dr, d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], mlp_type=cfg["moe"]["mlp_type"],
        moe=MoECfg(**cfg["moe"]), pattern=(BlockSpec("attn", "moe"),),
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["norm_eps"],
        dtype=cfg["dtype"], source=cfg["source"],
        mla=MLACfg(kv_lora_rank=R, qk_nope_head_dim=dn,
                   qk_rope_head_dim=dr, v_head_dim=dv,
                   rope_factor=float(rs["factor"]),
                   rope_original_max=rs["original_max_position_embeddings"],
                   beta_fast=float(rs["beta_fast"]),
                   beta_slow=float(rs["beta_slow"]),
                   mscale=float(rs["mscale"]),
                   mscale_all_dim=float(rs["mscale_all_dim"])),
        lead_dense_layers=n_lead(cfg))


# ----------------------------------------------------------------- weights
def _mla_shapes(cfg: dict) -> dict:
    d, H, R, dn, dr, dv = _dims(cfg)
    return {"wq": (d, H * (dn + dr)), "wkv_a": (d, R + dr), "kv_norm": (R,),
            "wkv_b": (R, H * (dn + dv)), "wo": (H * dv, d), "norm": (d,)}


def shape_tree(cfg: dict) -> dict:
    """Shapes of the weight tree (the program's input format)."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    lead = _mla_shapes(cfg)
    lead["mlp"] = W.mlp_shapes(d, cfg["intermediate_size"],
                               cfg["moe"]["mlp_type"])
    lead["mlp_norm"] = (d,)
    block = _mla_shapes(cfg)
    block.update(W.moe_shapes(cfg))
    return {"embed": (V, d), "unembed": (d, V), "final_norm": (d,),
            "lead": W.stack(lead, n_lead(cfg)),
            "blocks": {"pos0": W.stack(block, n_moe(cfg))}}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weight tree for ``seed`` on ``device``, in the model dtype."""
    dt = W.DTYPES[cfg["dtype"]]

    def lead_vectors(path: tuple, shape: tuple, dev):
        # Outside ``blocks`` a stacked vector looks like a matrix to the
        # draw; it is zero like every vector.
        if path[0] == "lead" and len(shape) == 2:
            return torch.zeros(shape, dtype=dt, device=dev)
        return None

    return W.draw(shape_tree(cfg), seed, device, cfg["dtype"],
                  rule=lead_vectors)


# ------------------------------------------------------------ work counts
def layer_work(cfg: dict) -> LayerWork:
    """The absorbed decode's non-expert terms (the embedding and
    unembedding apart)."""
    d, H, R, dn, dr, dv = _dims(cfg)
    moe = cfg["moe"]
    gated = W.gated(moe["mlp_type"])
    f, fs = cfg["intermediate_size"], moe.get("d_ff_shared") or moe["d_ff"]
    mla = d * H * (dn + dr) + d * (R + dr) + H * dn * R + H * R * dv \
        + H * dv * d
    dense = d * (2 * f if gated else f) + f * d
    shared = d * (2 * fs if gated else fs) + fs * d \
        if moe.get("n_shared_experts", 0) else 0
    L, Ld, Lm = cfg["num_hidden_layers"], n_lead(cfg), n_moe(cfg)
    mm = L * mla + Ld * dense + Lm * (d * moe["n_experts"] + shared)
    vec = L * (d + R) + Ld * d + Lm * d
    return LayerWork(mm=mm, weight_bytes=(mm + vec) * BF16 + d * BF16,
                     attn_flops_row=L * 2.0 * H * (R + dr + R),
                     kv_bytes_row=L * (R + dr) * BF16,
                     state_bytes=0, scan_flops=0)


# --------------------------------------------------------------- reference
def yarn(cfg: dict):
    """(inverse frequencies [rope / 2] in f32, cos/sin scale, softmax
    scale) from the published settings."""
    _, _, _, dn, dr, _ = _dims(cfg)
    rs, theta = cfg["rope_scaling"], float(cfg["rope_theta"])
    factor = float(rs["factor"])

    def m(s: float) -> float:
        return 0.1 * s * math.log(factor) + 1.0 if factor > 1 else 1.0

    def corr(rot: float) -> float:
        return dr * math.log(rs["original_max_position_embeddings"]
                             / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dr - 1)
    i = np.arange(dr // 2, dtype=np.float64)
    e = theta ** (-2.0 * i / dr)
    r = np.clip((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    inv = torch.tensor(e / factor * r + e * (1.0 - r), dtype=F32)
    sigma = (dn + dr) ** -0.5 * m(rs["mscale_all_dim"]) ** 2
    return inv, m(rs["mscale"]) / m(rs["mscale_all_dim"]), sigma


def _rope(x: torch.Tensor, inv: torch.Tensor, scale: float) -> torch.Tensor:
    """x: [L, n, D]; positions 0..L-1; each half rotated with the other."""
    L, _, D = x.shape
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] \
        * inv.to(x.device)
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mla(p, x, cfg, fp8):
    """One MLA layer over the sequence x [L, d], non-absorbed, with its
    residual."""
    L = x.shape[0]
    _, H, R, dn, dr, dv = _dims(cfg)
    inv, rs, sigma = yarn(cfg)
    h = _rms(x, p["norm"], cfg["norm_eps"])
    q = _mm(h, p["wq"], fp8).reshape(L, H, dn + dr)
    c = _mm(h, p["wkv_a"], fp8)
    c_kv = _rms(c[:, :R], p["kv_norm"], cfg["norm_eps"])
    k_pe = _rope(c[:, None, R:], inv, rs)
    kv = _mm(c_kv, p["wkv_b"], fp8).reshape(L, H, dn + dv)
    qf = torch.cat([q[..., :dn], _rope(q[..., dn:], inv, rs)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(L, H, dr)], dim=-1)
    v = kv[..., dn:]
    o = torch.empty(L, H, dv, dtype=F32, device=x.device)
    for i0 in range(0, L, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, L)
        s = torch.einsum("qhd,khd->hqk", qf[i0:i1], k[:i1]) * sigma
        qpos = torch.arange(i0, i1, device=x.device)[:, None]
        mask = torch.arange(i1, device=x.device)[None, :] <= qpos
        s = s.masked_fill(~mask, float("-inf"))
        o[i0:i1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                v[:i1])
    return x + _mm(o.reshape(L, H * dv), p["wo"], fp8)


def _dense(p, x, cfg, fp8):
    h = _rms(x, p["mlp_norm"], cfg["norm_eps"])
    return x + _swiglu(h, p["mlp"]["wi"], p["mlp"]["wo"], fp8)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def served_logits(cfg: dict, weights: dict, req: RefRequest, *,
                  theta: float = 0.5, fp8: bool = False,
                  flips: Optional[np.ndarray] = None) -> torch.Tensor:
    """Logits [1 + len(fed), V] (f32) at the positions that chose a served
    token: the prompt's last position, then each fed token's.  ``flips``
    ([len(fed)] ints), when given, counts at each decode position the MoE
    layers whose selection differs from the program's."""
    with no_tf32():
        dev = weights["embed"].device
        tokens = torch.as_tensor(np.concatenate([req.prompt, req.fed]),
                                 dtype=torch.long, device=dev)
        S = len(req.prompt)
        x = weights["embed"][tokens].to(F32)
        for i in range(n_lead(cfg)):
            p = _index(weights["lead"], i)
            x = _dense(p, _mla(p, x, cfg, fp8), cfg, fp8)
        for layer in range(n_moe(cfg)):
            p = _index(weights["blocks"]["pos0"], layer)
            x = _moe(p, _mla(p, x, cfg, fp8), cfg, (layer, 0), S,
                     req.contexts, fp8, theta, flips)
        h = _rms(x[S - 1:], weights["final_norm"], cfg["norm_eps"])
        return _mm(h, weights["unembed"], fp8)


def _moe_plain(p, x, cfg):
    """The MoE layer with plain top-k routing (gates renormalized) and the
    float experts; returns (x, ids [L, k])."""
    moe, m = cfg["moe"], p["moe"]
    h = _rms(x, p["moe_norm"], cfg["norm_eps"])
    probs = torch.softmax(_mm(h, m["w_router"], False), dim=-1)
    g, ids = top_k(probs, moe["top_k"])
    g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        rows, slots = torch.nonzero(ids == e, as_tuple=True)
        out = _swiglu(h[rows], m["experts"]["wi"][e], m["experts"]["wo"][e],
                      False)
        y.index_add_(0, rows, out * g[rows, slots][:, None])
    if "shared" in m:
        y = y + _swiglu(h, m["shared"]["wi"], m["shared"]["wo"], False)
    return x + y, ids


@torch.no_grad()
def plain_logits(cfg: dict, weights: dict, tokens) -> tuple:
    """The whole stack over ``tokens`` [L] with plain top-k routing and
    the float experts: (logits [L, V] f32, expert ids [MoE layers, L,
    k])."""
    with no_tf32():
        x = weights["embed"][torch.as_tensor(tokens, dtype=torch.long)]
        x = x.to(F32)
        for i in range(n_lead(cfg)):
            p = _index(weights["lead"], i)
            x = _dense(p, _mla(p, x, cfg, False), cfg, False)
        ids = []
        for layer in range(n_moe(cfg)):
            p = _index(weights["blocks"]["pos0"], layer)
            x, sel = _moe_plain(p, _mla(p, x, cfg, False), cfg)
            ids.append(sel)
        h = _rms(x, weights["final_norm"], cfg["norm_eps"])
        return _mm(h, weights["unembed"], False), torch.stack(ids)
