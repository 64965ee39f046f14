"""Model module ``periodic``: a stack of identical periods, each a pattern
of positions with an ``attn`` or ``ssm`` mixer and a ``dense`` or ``moe``
FFN (``cfg["pattern"]``, ``n_layers // len(pattern)`` periods).

What the harness asks of a model module (``portbench.lib.loader``):

* ``program_config(cfg)``: the program's ``ModelConfig``;
* ``shape_tree(cfg)``, ``make_weights(cfg, seed, device)``: the weight
  tree in the program's input format and its draw from the seed;
* ``served_logits(cfg, weights, req, *, theta, fp8=False, flips=None)``:
  the plain reference of one request (``reference.RefRequest``);
* ``moe_layout(cfg)``: the leading axes of the program's per-layer routing
  records; the number of MoE layers is their product;
* ``layer_work(cfg)``: the non-expert terms of the work counts
  (``counts.LayerWork``).

Here the weight tree is ``embed [V, d]``, ``unembed [d, V]``,
``final_norm [d]`` and ``blocks/pos{i}`` for each position of the
pattern, every leaf stacked over the periods; the routing records are
``[P, n_moe positions, ...]``.  The reference's layers: attention with
half-split RoPE, grouped KV heads and a causal mask; the SSD mixer as its
plain recurrence (``h = exp(dt*A) h + dt * x B``, ``y = h C + D x``, after
a causal depthwise conv and SiLU, with the gated RMSNorm before
``out_proj``); SwiGLU dense FFNs; the shared MoE layer
(``portbench/lib/reference.py``).  The SSD mixer's leaves are drawn by
the program's rule: ``A_log = log(linspace(1, 16, H))``, ``D = 1``,
``dt_bias = -2`` in f32 and ``conv_w`` normal times 0.2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.lib import weights as W
from portbench.lib.counts import BF16, F32 as F32_BYTES, LayerWork
from portbench.lib.reference import (F32, RefRequest, _mm, _moe, _rms,
                                     _swiglu, no_tf32)

_F32_SSM = ("A_log", "D", "dt_bias")


# ------------------------------------------------------------------ layout
def pattern(cfg: dict) -> list:
    return cfg["pattern"]


def n_periods(cfg: dict) -> int:
    return cfg["n_layers"] // len(pattern(cfg))


def moe_layout(cfg: dict) -> tuple:
    """(periods, MoE positions of the pattern)."""
    return (n_periods(cfg), sum(s["ffn"] == "moe" for s in pattern(cfg)))


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import BlockSpec, ModelConfig
    from repro_torch.models.moe import MoECfg
    from repro_torch.models.ssm import SSMCfg

    return ModelConfig(
        name=cfg["name"], arch_type=cfg["arch_type"],
        n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["d_ff"],
        vocab_size=cfg["vocab_size"], mlp_type=cfg["mlp_type"],
        moe=MoECfg(**cfg["moe"]),
        ssm=SSMCfg(**cfg["ssm"]) if "ssm" in cfg else None,
        pattern=tuple(BlockSpec(p["mixer"], p["ffn"])
                      for p in cfg["pattern"]),
        rope_theta=cfg["rope_theta"], norm_eps=cfg["norm_eps"],
        qkv_bias=cfg.get("qkv_bias", False), dtype=cfg["dtype"],
        source=cfg["source"])


# ----------------------------------------------------------------- weights
def ssm_dims(cfg: dict) -> dict:
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return {"d_inner": di, "heads": di // s["head_dim"],
            "head_dim": s["head_dim"], "d_state": s["d_state"],
            "d_conv": s["d_conv"], "conv_ch": di + 2 * s["d_state"]}


def _block(cfg: dict, spec: dict) -> dict:
    d, h, kv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    sh: dict = {}
    if spec["mixer"] == "attn":
        sh.update({"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
                   "wo": (h * hd, d), "norm": (d,)})
        if cfg.get("qkv_bias", False):
            sh.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    else:
        m = ssm_dims(cfg)
        H = m["heads"]
        sh["ssm"] = {
            "in_proj": (d, 2 * m["d_inner"] + 2 * m["d_state"] + H),
            "conv_w": (m["d_conv"], m["conv_ch"]),
            "conv_b": (m["conv_ch"],), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_scale": (m["d_inner"],),
            "out_proj": (m["d_inner"], d)}
        sh["ssm_norm"] = (d,)
    if spec["ffn"] == "dense":
        sh["mlp"] = W.mlp_shapes(d, cfg["d_ff"], cfg["mlp_type"])
        sh["mlp_norm"] = (d,)
    elif spec["ffn"] == "moe":
        sh.update(W.moe_shapes(cfg))
    return sh


def shape_tree(cfg: dict) -> dict:
    """Shapes of the weight tree (the program's input format)."""
    blocks = {f"pos{i}": W.stack(_block(cfg, spec), n_periods(cfg))
              for i, spec in enumerate(pattern(cfg))}
    return {"embed": (cfg["vocab_size"], cfg["d_model"]), "blocks": blocks,
            "final_norm": (cfg["d_model"],),
            "unembed": (cfg["d_model"], cfg["vocab_size"])}


def _ssm_rule(path: tuple, shape: tuple, device):
    if len(path) < 2 or path[-2] != "ssm":
        return None
    name = path[-1]
    if name == "A_log":
        row = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return row.expand(shape).contiguous()
    if name in _F32_SSM:
        fill = 1.0 if name == "D" else -2.0
        return torch.full(shape, fill, dtype=torch.float32, device=device)
    return 0.2 if name == "conv_w" else None


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weight tree for ``seed`` on ``device``, in the model dtype."""
    return W.draw(shape_tree(cfg), seed, device, cfg["dtype"],
                  rule=_ssm_rule)


# ------------------------------------------------------------ work counts
def layer_work(cfg: dict) -> LayerWork:
    """The non-expert weights (the embedding and unembedding apart), the
    attention layers' KV rows and the SSD layers' state and scan."""
    d, H, KV, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    mm, vec = 0, 0
    for spec in pattern(cfg):
        if spec["mixer"] == "attn":
            mm += d * (H + 2 * KV) * hd + H * hd * d
            vec += d + (H + 2 * KV) * hd * cfg.get("qkv_bias", False)
        else:
            s = cfg["ssm"]
            di = s["expand"] * d
            nh = di // s["head_dim"]
            mm += d * (2 * di + 2 * s["d_state"] + nh) + di * d
            vec += d + s["d_conv"] * (di + 2 * s["d_state"]) \
                + (di + 2 * s["d_state"]) + di + 3 * nh * 2
        if spec["ffn"] == "dense":
            n = 2 * cfg["d_ff"] if W.gated(cfg["mlp_type"]) else cfg["d_ff"]
            mm += d * n + cfg["d_ff"] * d
            vec += d
        elif spec["ffn"] == "moe":
            moe = cfg["moe"]
            mm += d * moe["n_experts"]
            if moe.get("n_shared_experts", 0):
                fs = moe.get("d_ff_shared") or moe["d_ff"]
                n = 2 * fs if W.gated(moe["mlp_type"]) else fs
                mm += d * n + fs * d
            vec += d
    P = n_periods(cfg)
    n_attn = sum(s["mixer"] == "attn" for s in pattern(cfg)) * P
    n_ssm = sum(s["mixer"] == "ssm" for s in pattern(cfg)) * P
    st, scan = 0, 0
    if n_ssm:
        s = cfg["ssm"]
        di = s["expand"] * d
        st = di * s["d_state"] * F32_BYTES \
            + (s["d_conv"] - 1) * (di + 2 * s["d_state"]) * BF16
        scan = 4 * di * s["d_state"]
    return LayerWork(
        mm=mm * P, weight_bytes=(mm + vec) * P * BF16 + d * BF16,
        attn_flops_row=n_attn * 4.0 * H * hd,
        kv_bytes_row=n_attn * 2 * KV * hd * BF16,
        state_bytes=n_ssm * st, scan_flops=n_ssm * scan)


# --------------------------------------------------------------- reference
def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [L, H, D]; positions 0..L-1."""
    L, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32,
                                       device=x.device) / D)
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, x, cfg, fp8):
    L = x.shape[0]
    H, KV, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = _rms(x, p["norm"], cfg["norm_eps"])
    q, k, v = (_mm(h, p[n], fp8) for n in ("wq", "wk", "wv"))
    if cfg.get("qkv_bias", False):
        q, k, v = q + p["bq"].to(F32), k + p["bk"].to(F32), \
            v + p["bv"].to(F32)
    q = _rope(q.reshape(L, H, D), cfg["rope_theta"])
    k = _rope(k.reshape(L, KV, D), cfg["rope_theta"])
    v = v.reshape(L, KV, D)
    rep = H // KV
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return x + _mm(o.reshape(L, H * D), p["wo"], fp8)


def _ssm(p, x, cfg, fp8):
    s = cfg["ssm"]
    L, d = x.shape
    di, N, Pd, K = s["expand"] * d, s["d_state"], s["head_dim"], s["d_conv"]
    H = di // Pd
    u = _rms(x, p["ssm_norm"], cfg["norm_eps"])
    m = p["ssm"]
    proj = _mm(u, m["in_proj"], fp8)
    z, xc, Bc, Cc, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    cin = torch.cat([xc, Bc, Cc], dim=-1)
    cin = F.pad(cin, (0, 0, K - 1, 0))
    w = m["conv_w"].to(F32)
    conv = sum(cin[i:i + L] * w[i] for i in range(K)) + m["conv_b"].to(F32)
    conv = F.silu(conv)
    xs, Bs, Cs = torch.split(conv, [di, N, N], dim=-1)
    xs = xs.reshape(L, H, Pd)
    A = -torch.exp(m["A_log"].to(F32))
    dt = dt + m["dt_bias"].to(F32)
    dt = dt.clamp_min(0.0) + torch.log1p(torch.exp(-dt.abs()))
    dA = torch.exp(dt * A)                                   # [L, H]
    h = torch.zeros(H, Pd, N, dtype=F32, device=x.device)
    ys = []
    for t in range(L):
        h = h * dA[t, :, None, None] \
            + (dt[t, :, None] * xs[t])[..., None] * Bs[t]
        ys.append(h @ Cs[t])
    y = torch.stack(ys) + xs * m["D"].to(F32)[None, :, None]
    yf = y.reshape(L, di) * F.silu(z)
    yn = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-5) \
        * (1.0 + m["norm_scale"].to(F32))
    return x + _mm(yn, m["out_proj"], fp8)


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
        moe_pos = [i for i, s in enumerate(pattern(cfg))
                   if s["ffn"] == "moe"]
        for period in range(n_periods(cfg)):
            for i, spec in enumerate(pattern(cfg)):
                p = _index(weights["blocks"][f"pos{i}"], period)
                x = _attention(p, x, cfg, fp8) if spec["mixer"] == "attn" \
                    else _ssm(p, x, cfg, fp8)
                if spec["ffn"] == "dense":
                    h = _rms(x, p["mlp_norm"], cfg["norm_eps"])
                    x = x + _swiglu(h, p["mlp"]["wi"], p["mlp"]["wo"], fp8)
                elif spec["ffn"] == "moe":
                    x = _moe(p, x, cfg, (period, moe_pos.index(i)), S,
                             req.contexts, fp8, theta, flips)
        h = _rms(x[S - 1:], weights["final_norm"], cfg["norm_eps"])
        return _mm(h, weights["unembed"], fp8)
