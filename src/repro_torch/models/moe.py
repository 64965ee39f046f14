"""Mixture-of-Experts layer with capacity-based dispatch (port of
``repro.models.moe``).

Three expert-weight representations share one dispatch/combine path:

* ``float``     — plain bf16/f32 expert weights ``experts/{wi, wo}``;
* ``quantized`` — AMAT codes ``experts/{wi_q, wo_q}`` (QuantizedTensor),
  optionally with the output-major ``wo_codes_t`` (the engine's tree,
  :func:`repro_torch.core.slices.quantize_moe_params`);
* ``flat``      — the same AMAT codes as plain leaves
  ``experts/{wi,wo}_{codes,scales,zps}`` (``quantized_serve``,
  :func:`quantize_params_for_serve`), read with ``mat``'s bits and group
  size; it has no ``wo_codes_t``, so ``wo`` runs on its K-major codes.

With ``quant_execution`` the expert FFN of either quantized form runs on
the packed codes through the Hopper kernel; otherwise the weights are
dequantized first (the eager oracle path).

Dispatch is the Switch/GShard capacity scheme: per-k-slot one-hot
position ranking, scatter into an ``[E, C, d]`` buffer, batched expert
matmuls, gather + combine.  The reference's sharding hints
(``shard_hint``) have no counterpart on one card and are gone.

With float experts and outside ``torch.no_grad()`` the layer is
differentiable as in the reference: gradients reach ``x`` through the
dispatch scatter and the gates through ``combine``; the aux leaves
``aux_loss`` (the Switch load-balance loss) and ``dropped_frac`` serve
training.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import routing as R
from repro_torch.core.amat import (MatConfig, amat_quantize_stacked,
                                   dequant_mixed)
from repro_torch.kernels.amat_matmul.ops import (amat_expert_matmul_qt,
                                                 amat_expert_matmul_t)
from repro_torch.models.layers import (ffn_activation, mlp_apply,
                                      mlp_param_shapes)
from repro_torch.quant.groupquant import QuantizedTensor, dequantize


@dataclasses.dataclass(frozen=True)
class RoutingPolicy:
    """Static cache-aware routing policy (SliceMoE engine; paper §2.1/§4.1).

    kind:        'topk' | 'cache_prior' | 'cumsum' | 'buddy'
    slice_mode:  'dbsc' | 'highbit' | 'lowbit' | 'amat_static'
    fetch_lsb_on_miss: if False, an LSB miss degrades the expert to
                 MSB-only compute instead of fetching (needs cached_lsb).
    quant_execution: run the expert FFN directly on packed AMAT codes
                 through the batched-expert Hopper kernel.
    """

    kind: str = "topk"
    slice_mode: str = "dbsc"
    theta: float = 0.5
    cumsum_tau: float = 0.9
    cumsum_kmax: int = 8
    fetch_lsb_on_miss: bool = True
    quant_execution: bool = False


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert FFN width
    n_shared_experts: int = 0
    d_ff_shared: int = 0           # total shared-expert width
    capacity_factor: float = 1.25
    mlp_type: str = "swiglu"
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------
def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """[T, d] @ [d, E] -> softmax probs [T, E] (f32)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    return torch.softmax(logits, dim=-1)


def topk_select(probs: torch.Tensor, k: int, *, renormalize: bool = True):
    """Top-k routing: returns (gates [T,k], ids [T,k]); ties go to the
    lower expert index (:func:`repro_torch.core.routing.top_k`)."""
    if renormalize:
        return R.topk_routing(probs, k)
    return R.top_k(probs, k)


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * <f_e> . <p_e>.  A masked token's
    sentinel id one-hots to zero and counts toward no expert."""
    sel = R.one_hot(ids, n_experts, torch.float32)            # [T, k, E]
    frac_tokens = torch.mean(torch.sum(sel, dim=1), dim=0)    # [E]
    mean_probs = torch.mean(probs, dim=0)                     # [E]
    return n_experts * torch.sum(frac_tokens * mean_probs)


# --------------------------------------------------------------------------
# Dispatch / combine
# --------------------------------------------------------------------------
def capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(n_tokens * k * factor / n_experts) + 1
    return max(8, min(c, n_tokens))


def dispatch_indices(ids: torch.Tensor, gates: torch.Tensor, n_experts: int,
                     cap: int):
    """Per-(token, slot) expert positions under a capacity limit.

    Returns (positions [T,k] int64, keep [T,k] bool).  Slot priority
    follows k order (GShard).  A masked token's sentinel id ``n_experts``
    one-hots to zero: position 0, kept, and it consumes no capacity.
    """
    T, k = ids.shape
    positions, keeps = [], []
    counts = torch.zeros((n_experts,), dtype=torch.int64, device=ids.device)
    for kk in range(k):
        onehot = R.one_hot(ids[:, kk], n_experts, torch.int64)  # [T, E]
        pos_in_e = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        pos = torch.sum(pos_in_e * onehot, dim=-1)
        keep = pos < cap
        positions.append(pos)
        keeps.append(keep)
        counts = counts + torch.sum(onehot * keep[:, None], dim=0)
    return torch.stack(positions, 1), torch.stack(keeps, 1)


def dispatch(x: torch.Tensor, ids: torch.Tensor, positions: torch.Tensor,
             keep: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """Scatter tokens into a contiguous [E, C, d] expert buffer.

    The reference scatters with ``mode="drop"``: the sentinel expert id
    ``n_experts`` (masked tokens) and the overflow slot ``cap`` (dropped
    tokens) fall outside the buffer and vanish.  Torch indexing raises on
    both, so the buffer is allocated ``[E+1, cap+1, d]`` and the spare
    row and column are sliced off.
    """
    T, k = ids.shape
    d = x.shape[-1]
    flat_ids = ids.reshape(-1)
    flat_pos = torch.where(keep, positions,
                           torch.full_like(positions, cap)).reshape(-1)
    xk = x[:, None, :].expand(T, k, d).reshape(-1, d)
    buf = torch.zeros((n_experts + 1, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((flat_ids, flat_pos), xk, accumulate=True)
    return buf[:n_experts, :cap].contiguous()


def combine(y_buf: torch.Tensor, ids: torch.Tensor, positions: torch.Tensor,
            keep: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs back to tokens and mix with gates.

    JAX clamps an out-of-range gather index; the sentinel id is clamped
    the same way here, and its zeroed gate nulls the row.
    """
    T, k = ids.shape
    E, C = y_buf.shape[0], y_buf.shape[1]
    flat_ids = torch.clamp(ids.reshape(-1), 0, E - 1)
    flat_pos = torch.clamp(positions.reshape(-1), 0, C - 1)
    y = y_buf[flat_ids, flat_pos].reshape(T, k, -1)
    w = (gates * keep.to(gates.dtype))[..., None]
    return torch.sum(y * w.to(y.dtype), dim=1)


# --------------------------------------------------------------------------
# Expert compute
# --------------------------------------------------------------------------
def _expert_ffn(xe: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                mlp_type: str) -> torch.Tensor:
    """Batched per-expert FFN. xe: [E, C, d]; wi: [E, d, F(|2F)];
    wo: [E, F, d]."""
    h = ffn_activation(torch.bmm(xe, wi.to(xe.dtype)), mlp_type, xe.dtype)
    return torch.bmm(h, wo.to(xe.dtype))


def _expert_ffn_quant(xe: torch.Tensor, wi_q: QuantizedTensor,
                      wo_q: QuantizedTensor,
                      wo_codes_t: Optional[torch.Tensor],
                      use_lsb: Optional[torch.Tensor],
                      shift: int, mlp_type: str) -> torch.Tensor:
    """Expert FFN computed directly on packed AMAT codes: two launches of
    the batched-expert kernel, ``wi`` K-major and ``wo`` output-major (or
    K-major when no pre-transposed codes are given), with the FFN's
    activation between them."""
    ul = use_lsb if use_lsb is not None \
        else torch.ones((xe.shape[0],), dtype=torch.bool, device=xe.device)
    h = amat_expert_matmul_qt(xe, wi_q, ul, shift=shift).to(xe.dtype)
    h = ffn_activation(h, mlp_type, xe.dtype)
    if wo_codes_t is not None:
        y = amat_expert_matmul_t(h, wo_codes_t, wo_q.scales,
                                 wo_q.zero_points, ul, shift=shift,
                                 group_size=wo_q.group_size)
    else:
        y = amat_expert_matmul_qt(h, wo_q, ul, shift=shift)
    return y.to(xe.dtype)


def _dequant_experts(qt: QuantizedTensor, use_lsb: Optional[torch.Tensor],
                     shift: int, dtype) -> torch.Tensor:
    """Dequantize stacked expert weights [E, K, N] with per-expert precision."""
    if use_lsb is None or shift == 0:
        w = dequantize(qt)
    else:
        w = dequant_mixed(qt, use_lsb, shift)
    return w.to(dtype)


def moe_apply(
    params: dict,
    x: torch.Tensor,                          # [T, d] flat tokens
    cfg: MoECfg,
    *,
    use_lsb: Optional[torch.Tensor] = None,   # [E] bool (quantized only)
    mat: Optional[MatConfig] = None,
    gate_override: Optional[tuple] = None,    # (gates [T,k], ids [T,k])
    policy: Optional[RoutingPolicy] = None,
    policy_state: Optional[dict] = None,      # {'alpha', 'cached_msb' [E],
                                              #  'cached_lsb' [E]}
    token_mask: Optional[torch.Tensor] = None,  # [T] bool; False = padding
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    quant_execution: Optional[bool] = None,   # None -> policy decides
    force_high_bit: bool = False,             # prefill: policy routes,
                                              # compute stays high-bit
):
    """Full MoE layer.  Returns (y [T, d], aux: dict of tensors).

    ``gate_override`` routes by the given (gates, ids) instead of the
    router; ``use_lsb`` [E] picks MSB+LSB (True) or MSB-only compute per
    expert on quantized experts (a ``policy`` sets its own).  Without a
    policy or an override, ``deterministic=False`` with an ``rng`` (a
    ``torch.Generator`` on ``x``'s device) jitters the router's
    probabilities by a uniform factor in ``[1 - router_noise, 1 +
    router_noise]`` before the top-k, as the reference does (its numbers
    come from ``jax.random``, which a generator cannot reproduce).

    ``token_mask`` redirects padding rows' ids to the out-of-range id
    ``n_experts``: they take no expert capacity, never appear in the
    slice demand, and cannot evict a live token under the capacity limit.
    """
    T, d = x.shape
    E = cfg.n_experts
    probs = router_probs(x, params["w_router"])
    active = None
    critical = None

    def mask_routing(gates, ids, active):
        if token_mask is None:
            return gates, ids, active
        tm = token_mask.to(torch.bool)
        ids = torch.where(tm[:, None], ids, torch.full_like(ids, E))
        gates = gates * tm[:, None].to(gates.dtype)
        active = tm[:, None].expand(ids.shape) if active is None \
            else (active & tm[:, None])
        return gates, ids, active

    if gate_override is not None:
        if policy is not None:
            raise ValueError("gate_override and policy are exclusive: the "
                             "override replaces the policy's routing")
        gates, ids = gate_override
        gates, ids, active = mask_routing(gates, ids, active)
        k_eff = ids.shape[-1]
    elif policy is not None:
        if policy.kind == "cache_prior":
            gates, ids = R.cache_prior_routing(
                probs, policy_state["cached_msb"], policy_state["alpha"],
                cfg.top_k)
        elif policy.kind == "buddy":
            gates, ids = R.buddy_routing(
                probs, policy_state["cached_msb"], policy_state["buddies"],
                cfg.top_k)
        elif policy.kind == "cumsum":
            kmax = min(policy.cumsum_kmax, E)
            gates, ids, active = R.cumsum_routing(probs, policy.cumsum_tau,
                                                  kmax)
        elif policy.kind == "topk":
            gates, ids = R.topk_routing(probs, cfg.top_k)
        else:
            raise ValueError(f"unknown routing kind {policy.kind!r}")
        gates, ids, active = mask_routing(gates, ids, active)
        gates = gates.to(x.dtype)
        k_eff = ids.shape[-1]

        critical = R.criticality(gates.to(torch.float32), policy.theta)
        if active is not None:
            critical = critical & active
        msb_needed, lsb_needed = R.expert_demand(ids, critical, E)
        if active is not None:
            sel = R.one_hot(ids, E)
            msb_needed = (sel & active[..., None]).any(dim=1).any(dim=0)
        if policy.slice_mode == "highbit":
            use_lsb = torch.ones((E,), dtype=torch.bool, device=x.device)
            lsb_needed = msb_needed
        elif policy.slice_mode in ("lowbit", "amat_static"):
            use_lsb = torch.zeros((E,), dtype=torch.bool, device=x.device)
            lsb_needed = torch.zeros((E,), dtype=torch.bool,
                                     device=x.device)
        else:  # dbsc
            use_lsb = lsb_needed
            if not policy.fetch_lsb_on_miss and policy_state is not None:
                use_lsb = lsb_needed & policy_state["cached_lsb"]
        if force_high_bit:
            use_lsb = None
    else:
        p = probs
        if not deterministic and cfg.router_noise > 0 and rng is not None:
            u = torch.rand(probs.shape, generator=rng, device=probs.device,
                           dtype=probs.dtype)
            p = p * ((1.0 - cfg.router_noise) + 2.0 * cfg.router_noise * u)
        gates, ids = topk_select(p, cfg.top_k)
        gates, ids, active = mask_routing(gates, ids, active)
        gates = gates.to(x.dtype)
        k_eff = cfg.top_k

    cap = capacity(T, k_eff, E, cfg.capacity_factor)
    positions, keep = dispatch_indices(ids, gates, E, cap)
    xe = dispatch(x, ids, positions, keep, E, cap)

    experts = params["experts"]
    quant_exec = quant_execution if quant_execution is not None else \
        (policy.quant_execution if policy is not None else False)
    if "wi_q" in experts or "wi_codes" in experts:
        if mat is None:
            raise ValueError("quantized experts need a MatConfig (mat=)")
        if "wi_q" in experts:
            wi_qt, wo_qt = experts["wi_q"], experts["wo_q"]
        else:
            wi_qt, wo_qt = (QuantizedTensor(
                experts[f"{n}_codes"], experts[f"{n}_scales"],
                experts[f"{n}_zps"], mat.high_bits, mat.group_size, True)
                for n in ("wi", "wo"))
        if quant_exec:
            ye = _expert_ffn_quant(xe, wi_qt, wo_qt, experts.get("wo_codes_t"),
                                   use_lsb, mat.shift, cfg.mlp_type)
        else:
            wi = _dequant_experts(wi_qt, use_lsb, mat.shift, x.dtype)
            wo = _dequant_experts(wo_qt, use_lsb, mat.shift, x.dtype)
            ye = _expert_ffn(xe, wi, wo, cfg.mlp_type)
    else:
        ye = _expert_ffn(xe, experts["wi"], experts["wo"], cfg.mlp_type)
    y = combine(ye, ids, positions, keep, gates)

    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(params["shared"], x, cfg.mlp_type)

    aux = {
        "ids": ids,
        "gates": gates,
        "aux_loss": load_balance_loss(probs, ids, E),
        "dropped_frac": 1.0 - torch.mean(keep.to(torch.float32)),
    }
    if policy is not None:
        ones_e = torch.ones((E,), dtype=torch.bool, device=x.device)
        aux["critical"] = critical
        aux["msb_needed"] = msb_needed
        aux["lsb_needed"] = lsb_needed
        aux["use_lsb"] = use_lsb if use_lsb is not None else ones_e
        aux["active"] = active if active is not None \
            else torch.ones(ids.shape, dtype=torch.bool, device=x.device)
    return y, aux


def quantize_params_for_serve(params: dict, cfg, mat: MatConfig) -> dict:
    """Replace float expert weights by flat-dict AMAT tensors (the
    ``quantized_serve`` form): each MoE block's ``experts`` becomes
    ``{wi,wo}_{codes,scales,zps}`` (codes and zero-points ``uint8``,
    scales f32), quantized one expert matrix at a time
    (:func:`repro_torch.core.amat.amat_quantize_stacked`: the reference's
    codes, scales and zero-points, without its whole-stack f32 copy).
    Every other leaf is the same tensor, not a copy."""
    new_blocks = {}
    for pos, blk in params["blocks"].items():
        if "moe" in blk:
            blk = dict(blk)
            moe = dict(blk["moe"])
            e = moe["experts"]
            out = {}
            for name in ("wi", "wo"):
                qt = amat_quantize_stacked(e[name], mat)
                out[f"{name}_codes"] = qt.codes
                out[f"{name}_scales"] = qt.scales
                out[f"{name}_zps"] = qt.zero_points
            moe["experts"] = out
            blk["moe"] = moe
        new_blocks[pos] = blk
    new_params = dict(params)
    new_params["blocks"] = new_blocks
    return new_params


def quantized_expert_shapes(d_model: int, cfg: MoECfg,
                            group_size: int = 32) -> dict:
    """Shapes of the flat-dict AMAT experts of one MoE layer."""
    wi_cols = 2 * cfg.d_ff if cfg.mlp_type in ("swiglu", "geglu") else cfg.d_ff
    E = cfg.n_experts
    return {
        "wi_codes": (E, d_model, wi_cols),
        "wi_scales": (E, d_model // group_size, wi_cols),
        "wi_zps": (E, d_model // group_size, wi_cols),
        "wo_codes": (E, cfg.d_ff, d_model),
        "wo_scales": (E, cfg.d_ff // group_size, d_model),
        "wo_zps": (E, cfg.d_ff // group_size, d_model),
    }


def moe_param_shapes(d_model: int, cfg: MoECfg) -> dict:
    wi_cols = 2 * cfg.d_ff if cfg.mlp_type in ("swiglu", "geglu") else cfg.d_ff
    shapes = {
        "w_router": (d_model, cfg.n_experts),
        "experts": {
            "wi": (cfg.n_experts, d_model, wi_cols),
            "wo": (cfg.n_experts, cfg.d_ff, d_model),
        },
    }
    if cfg.n_shared_experts > 0:
        shapes["shared"] = mlp_param_shapes(
            d_model, cfg.d_ff_shared or cfg.d_ff, cfg.mlp_type)
    return shapes
