"""Analytic FLOP / HBM-traffic model per (arch x input-shape) (port of
``repro.launch.costs``, a copy: numpy and dataclasses only).

Why analytic: the reference's XLA ``compiled.cost_analysis()`` counts a
``while`` body once, not x trip-count, so its HLO numbers understate a
scanned layer stack by ~the layer count; and the port's ``meta`` run
counts nothing at all.  Both packages' rooflines therefore rest on this
model for the compute and memory terms (exact matmul accounting for a
workload we define ourselves).  The reference takes collective bytes
from the HLO; the port has no partitioner and records none
(``launch/dryrun.py``).

Conventions: one fused-multiply-add = 2 FLOPs.  Training cost multiplier
for in-scan weights: fwd + remat-fwd + backward(2x fwd) = 4x forward
FLOPs (we checkpoint per period, paper-standard remat).  Bytes model is
a *traffic lower bound*: each weight read once per pass from HBM,
activations r/w at block boundaries, KV cache streamed once per decode
step, optimizer state r/w in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeConfig


@dataclasses.dataclass
class Costs:
    flops: float
    hbm_bytes: float
    detail: dict


def _mm(m, k, n) -> float:
    return 2.0 * m * k * n


def _block_fwd_flops(cfg: ModelConfig, spec: BlockSpec, T: float,
                     B: float, s_ctx: float, decode: bool) -> float:
    d = cfg.d_model
    f = 0.0
    if spec.mixer == "attn":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        f += _mm(T, d, h * hd) + 2 * _mm(T, d, kv * hd) + _mm(T, h * hd, d)
        if decode:
            f += 2 * _mm(B * h, s_ctx, hd)            # scores + AV, q_len=1
        else:
            # causal: ~half the square (window-clipped)
            eff = min(s_ctx, cfg.sliding_window or s_ctx)
            f += 2 * 2.0 * B * h * s_ctx * eff * 0.5 * hd
        if cfg.is_encdec:
            f += _mm(T, d, h * hd) + _mm(T, h * hd, d) \
                + 2 * _mm(B * h, cfg.encoder_seq, hd) * (1 if decode else s_ctx / 1)
    else:
        ssm = cfg.ssm
        di = ssm.d_inner(d)
        hs, p, n = ssm.n_heads(d), ssm.head_dim, ssm.d_state
        f += _mm(T, d, ssm.in_proj_cols(d))
        f += 2.0 * T * ssm.conv_channels(d) * ssm.d_conv
        if decode:
            f += 2 * 2.0 * B * hs * p * n             # state update + out
        else:
            Q = ssm.chunk
            f += _mm(B * (T / B / Q), Q, n) * Q        # CB intra
            f += 2.0 * T * Q * hs * p                  # L*x intra
            f += 2 * 2.0 * T * n * hs * p              # states + y_off
        f += _mm(T, di, d)
    # FFN
    if spec.ffn == "dense":
        wi = 2 * cfg.d_ff if cfg.mlp_type in ("swiglu", "geglu") else cfg.d_ff
        f += _mm(T, d, wi) + _mm(T, cfg.d_ff, d)
    elif spec.ffn == "moe":
        m = cfg.moe
        wi = 2 * m.d_ff if m.mlp_type in ("swiglu", "geglu") else m.d_ff
        routed = T * m.top_k * m.capacity_factor
        f += _mm(T, d, m.n_experts)                    # router
        f += _mm(routed, d, wi) + _mm(routed, m.d_ff, d)
        if m.n_shared_experts:
            dsh = m.d_ff_shared or m.d_ff
            wish = 2 * dsh if m.mlp_type in ("swiglu", "geglu") else dsh
            f += _mm(T, d, wish) + _mm(T, dsh, d)
    return f


def param_bytes(cfg: ModelConfig) -> float:
    """Total parameter bytes, dtype-aware (bf16 / f32 ssm / uint8 codes)."""
    from repro_torch.launch.sharding import tree_paths
    from repro_torch.models.model import param_shapes

    total = 0.0
    for path, shape in tree_paths(param_shapes(cfg)):
        n = float(np.prod(shape))
        if path.endswith(("_codes", "_zps")):
            total += n                       # uint8
        elif path.endswith("_scales") or "A_log" in path or "/D" in path \
                or "dt_bias" in path:
            total += 4.0 * n                 # f32
        else:
            total += 2.0 * n                 # bf16
    return total


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig) -> Costs:
    B = shape.global_batch
    S = shape.seq_len
    decode = shape.kind == "decode"
    T = float(B) if decode else float(B * S)
    s_ctx = float(S)
    d = cfg.d_model
    V = cfg.vocab_size

    # ---- forward flops over all layers -------------------------------
    layer_f = 0.0
    for spec in cfg.block_pattern:
        layer_f += _block_fwd_flops(cfg, spec, T, B, s_ctx, decode)
    layer_f *= cfg.n_periods
    if cfg.is_encdec and not decode:
        enc_T = float(B * cfg.encoder_seq)
        enc_f = cfg.encoder_layers * _block_fwd_flops(
            cfg, BlockSpec("attn", "dense"), enc_T, B,
            float(cfg.encoder_seq), False)
        layer_f += enc_f

    # embedding gather is ~free; unembed is a matmul
    T_loss = T if shape.kind == "train" else float(B)
    head_f = _mm(T_loss, d, V)

    if shape.kind == "train":
        # fwd + remat-recompute + bwd(2x); 'dots' policy saves matmul
        # outputs so the recompute pass skips them (elementwise only).
        remat_mult = 4.0 if cfg.remat_policy == "full" else 3.0
        flops = remat_mult * layer_f + 3.0 * head_f
    else:
        flops = layer_f + head_f

    # ---- HBM traffic --------------------------------------------------
    P = param_bytes(cfg)
    act_unit = T * d * 2.0                       # one residual tensor, bf16
    n_layers = cfg.n_layers + cfg.encoder_layers
    if shape.kind == "train":
        # weights: fwd + remat + 2x bwd reads + grad write; opt: m,v,master
        # read+write in f32 (= 6x param count in f32 bytes)
        w_traffic = 4.0 * P + P + 6.0 * (P * 2.0)
        a_traffic = 8.0 * act_unit * n_layers    # r/w at block boundaries,
        #                                          fwd + recompute + bwd
        logits_traffic = 2.0 * T_loss * V * 4.0 / 16.0  # chunked (1/16 live)
        kv_traffic = 0.0
    elif shape.kind == "prefill":
        w_traffic = P
        a_traffic = 4.0 * act_unit * n_layers
        logits_traffic = T_loss * V * 4.0
        kv_traffic = 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads \
            * cfg.head_dim * 2.0 if cfg.has_attention else 0.0
    else:  # decode
        w_traffic = P
        a_traffic = 4.0 * act_unit * n_layers
        logits_traffic = T_loss * V * 4.0
        kv_traffic = 0.0
        kv_elem_bytes = 1.0 if cfg.kv_dtype == "int8" else 2.0
        for spec in cfg.block_pattern:
            if spec.mixer == "attn":
                eff = min(S, cfg.sliding_window or S) if cfg.subquadratic \
                    else S
                kv_traffic += cfg.n_periods * 2.0 * B * eff \
                    * cfg.n_kv_heads * (cfg.head_dim * kv_elem_bytes
                                        + (4.0 if cfg.kv_dtype == "int8"
                                           else 0.0))
            else:
                ssm = cfg.ssm
                kv_traffic += cfg.n_periods * B * ssm.n_heads(d) \
                    * ssm.head_dim * ssm.d_state * 4.0 * 2.0

    hbm = w_traffic + a_traffic + logits_traffic + kv_traffic
    return Costs(flops=flops, hbm_bytes=hbm, detail={
        "layer_fwd_flops": layer_f,
        "head_flops": head_f,
        "param_bytes": P,
        "weight_traffic": w_traffic,
        "activation_traffic": a_traffic,
        "kv_traffic": kv_traffic,
        "logits_traffic": logits_traffic,
    })


def model_flops_reference(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference) — the MFU reference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
