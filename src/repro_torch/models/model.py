"""Model stack for the ``moe`` architecture (port of ``repro.models.model``).

Parameters keep the reference's tree and its stacked ``[n_periods, ...]``
layout (``blocks/pos{i}/...``), so :mod:`repro_torch.bridge` maps the JAX
package's parameters onto the port one leaf to one leaf.  The reference
``lax.scan``s over periods; here a Python loop indexes each period's
slice (a view, no copy).

Public entry points: ``param_shapes`` / ``init_params``, ``embed_inputs``,
``forward`` (full sequence, differentiable), ``lm_loss`` (chunked
cross-entropy plus the MoE load-balance loss), ``unembed``,
``init_cache``, ``prefill``, ``decode_step`` (scalar and ``[B]``
positions, ``token_mask``), ``count_params``.  With ``kv_dtype="int8"``
the KV cache holds per-(token, head) int8 codes and f32 scales
(``_quant_kv`` / ``_dequant_kv``), dequantized to the model dtype before
each decode attention.  The reference wraps each
period of ``forward`` in ``jax.checkpoint`` (remat); that changes memory,
not values, and is not ported.

Departures from the functional reference, both to save device memory:
``decode_step`` writes the new KV row into the cache tensors in place
and returns a dict holding those same tensors (with ``pos`` advanced);
``init_params`` draws each stacked leaf one period at a time.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.quant.groupquant import QuantizedTensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
LOSS_CHUNKS = 16


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.arch_type != "moe":
        raise NotImplementedError(
            f"{cfg.name}: only the 'moe' architecture is ported "
            "(ROADMAP.md queue 1, 'remaining architectures')")
    if cfg.ring_kv or cfg.prefix_len or cfg.encoder_layers \
            or cfg.quantized_serve or cfg.pad_vocab_to != 1 \
            or cfg.tie_embeddings or cfg.sliding_window or cfg.always_swa \
            or cfg.logit_softcap is not None or cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: ring KV, prefix embeddings, encoders, "
            "quantized_serve, vocab padding, tied embeddings, sliding "
            "windows, logit soft-capping and MLPs other than SwiGLU are not "
            "ported yet (ROADMAP.md queue 1, 'remaining architectures')")


# ==========================================================================
# Parameter shapes / init
# ==========================================================================
def _attn_shapes(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sh = {
        "wq": (d, h * hd),
        "wk": (d, kv * hd),
        "wv": (d, kv * hd),
        "wo": (h * hd, d),
        "norm": (d,),
    }
    if cfg.qkv_bias:
        sh["bq"] = (h * hd,)
        sh["bk"] = (kv * hd,)
        sh["bv"] = (kv * hd,)
    return sh


def _block_shapes(cfg: ModelConfig, spec: BlockSpec) -> dict:
    sh = dict(_attn_shapes(cfg))
    if spec.ffn == "dense":
        sh["mlp"] = L.mlp_param_shapes(cfg.d_model, cfg.d_ff, cfg.mlp_type)
        sh["mlp_norm"] = (cfg.d_model,)
    elif spec.ffn == "moe":
        sh["moe"] = M.moe_param_shapes(cfg.d_model, cfg.moe)
        sh["moe_norm"] = (cfg.d_model,)
    return sh


def _stack(shapes: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of shape-tuples mirroring the param tree."""
    _check_supported(cfg)
    blocks = {f"pos{i}": _stack(_block_shapes(cfg, spec), cfg.n_periods)
              for i, spec in enumerate(cfg.block_pattern)}
    return {
        "embed": (cfg.vocab_size, cfg.d_model),
        "blocks": blocks,
        "final_norm": (cfg.d_model,),
        "unembed": (cfg.d_model, cfg.padded_vocab),
    }


def shape_leaves(tree: dict) -> Iterator[tuple]:
    """Shape tuples of a shape tree, in sorted-key order (JAX's order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from shape_leaves(v)
        else:
            yield v


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``: zeros for vectors, normal at
    ``fan_in^-0.5`` for matrices (the reference's rule; ``torch.Generator``
    cannot reproduce ``jax.random``'s numbers, so parity tests carry JAX
    parameters across with :mod:`repro_torch.bridge`).

    Stacked leaves are drawn one period at a time in f32 and cast into a
    preallocated tensor of the model dtype, so the peak temporary is one
    period of one leaf, never a whole stack in f32.
    """
    dev = resolve_device(device)
    dtype = _dt(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def init_tree(shapes: dict) -> dict:
        out = {}
        for k in sorted(shapes):
            v = shapes[k]
            out[k] = init_tree(v) if isinstance(v, dict) else init_one(v)
        return out

    def init_one(shape):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        if len(shape) == 1 or shape[-1] == 1:
            return t
        std = shape[-2] ** -0.5
        chunks = list(t) if len(shape) >= 3 else [t]
        for chunk in chunks:
            draw = torch.randn(chunk.shape, generator=gen, device=dev,
                               dtype=torch.float32)
            chunk.copy_(draw.mul_(std))
        return t

    return init_tree(param_shapes(cfg))


def _index(tree, i: int):
    """Period ``i`` of a stacked parameter/cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.index(i)
    return tree[i]


# ==========================================================================
# Blocks
# ==========================================================================
def _attn_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _self_attn_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor):
    """Causal self-attention over the whole sequence with its residual;
    returns (x, (k, v)) with ``k``/``v`` after RoPE (the cache rows)."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.attention(q, k, v, causal=True)
    return x + o.reshape(b, s, -1) @ p["wo"], (k, v)


def _ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
               *, collect: bool, policy=None, policy_state=None, mat=None,
               token_mask=None, quant_execution=None, force_high_bit=False):
    """The block's FFN half; returns (x, aux): the MoE layer's whole aux
    with ``collect``, else only its ``aux_loss`` and ``dropped_frac``
    (None for a dense FFN)."""
    if spec.ffn == "dense":
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(p["mlp"], h, cfg.mlp_type), None
    h = L.rms_norm(x, p["moe_norm"], cfg.norm_eps)
    b, s, d = h.shape
    y, aux = M.moe_apply(
        p["moe"], h.reshape(-1, d), cfg.moe, policy=policy,
        policy_state=policy_state, mat=mat, token_mask=token_mask,
        quant_execution=quant_execution, force_high_bit=force_high_bit)
    if not collect:
        aux = {"aux_loss": aux["aux_loss"],
               "dropped_frac": aux["dropped_frac"]}
    return x + y.reshape(b, s, d), aux


def _stack_aux(per_period: list) -> dict:
    """[[aux per moe position] per period] -> leaves [P, n_moe_pos, ...]."""
    if not per_period or not per_period[0]:
        return {}
    keys = per_period[0][0].keys()
    return {k: torch.stack([torch.stack([a[k] for a in row])
                            for row in per_period]) for k in keys}


# ==========================================================================
# Full-sequence pieces
# ==========================================================================
def embed_inputs(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(_dt(cfg))


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    """Full-sequence forward over float experts (the training path).
    tokens: [B, S] int.  Returns (hidden [B, S, d] after the final norm,
    aux): ``aux["aux_loss"]`` sums the MoE layers' load-balance losses;
    ``aux["moe"]`` holds their ``aux_loss`` and ``dropped_frac`` stacked
    ``[n_periods, n_moe_pos]``.  Differentiable unless run under
    ``torch.no_grad()``."""
    _check_supported(cfg)
    x = embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            p = period_params[f"pos{i}"]
            x, _ = _self_attn_block(p, x, cfg, positions)
            x, aux = _ffn_block(p, x, cfg, spec, collect=False)
            if aux is not None:
                row.append(aux)
        aux_rows.append(row)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    stacked = _stack_aux(aux_rows)
    if stacked:
        return x, {"moe": stacked, "aux_loss": torch.sum(stacked["aux_loss"])}
    return x, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return (h @ params["unembed"].to(h.dtype)).to(torch.float32)


def lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, aux_weight: float = 0.01):
    """Mean next-token cross-entropy over the flattened token stream,
    plus ``aux_weight`` times the load-balance loss; returns (loss, aux).
    The logits are formed ``LOSS_CHUNKS`` token chunks at a time (one
    chunk when the token count does not divide), never as one [T, V]."""
    h, aux = forward(params, cfg, tokens)
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    lf = labels.reshape(-1)
    T = hf.shape[0]
    n_chunks = LOSS_CHUNKS if T % LOSS_CHUNKS == 0 else 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hx, lx in zip(hf.reshape(n_chunks, T // n_chunks, d),
                      lf.reshape(n_chunks, T // n_chunks)):
        logits = unembed(params, cfg, hx)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx[:, None].long())[:, 0]
        total = total + torch.sum(logz - gold)
    loss = total / T
    return loss + aux_weight * aux["aux_loss"], aux


# ==========================================================================
# Decode cache
# ==========================================================================
KV_SCALE_FLOOR = 1e-8
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quant_kv(x: torch.Tensor):
    """Per-(token, head) dynamic int8 quantization of K/V rows.

    x: [..., hd] -> (codes int8 [..., hd], scales f32 [...]).  Rounding
    is half to even, as ``jnp.round``.  The reference's ``amax / 127.0``
    compiles to a multiply by the f32 reciprocal (XLA's rewrite, as for
    the AMAT scale); the port writes that multiply, so the scales match
    the compiled reference exactly.
    """
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax * _INV_127, KV_SCALE_FLOOR)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _dequant_kv(codes: torch.Tensor, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Decode-state tree, stacked over periods per pattern position.
    With ``kv_dtype="int8"`` each entry also holds ``k_scale`` /
    ``v_scale`` [n_periods, B, S, Hkv] f32."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dt(cfg)
    int8_kv = cfg.kv_dtype == "int8"
    cache: dict = {"pos": torch.zeros((), dtype=torch.int64, device=dev)}
    kv_shape = (cfg.n_periods, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = torch.int8 if int8_kv else dtype
    for i, spec in enumerate(cfg.block_pattern):
        entry = {"k": torch.zeros(kv_shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(kv_shape, dtype=kv_dt, device=dev)}
        if int8_kv:
            for name in ("k_scale", "v_scale"):
                entry[name] = torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                          device=dev)
        cache[f"pos{i}"] = entry
    return cache


# ==========================================================================
# Prefill
# ==========================================================================
@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, *, collect_trace: bool = False, mat=None,
            quant_execution: Optional[bool] = None, policy=None):
    """Forward over the prompt, returning (last-token logits, cache, aux).

    ``policy``: optional *state-free* RoutingPolicy (cumsum) to route the
    prompt with; compute stays high-bit for every routed expert.
    """
    x = embed_inputs(params, cfg, tokens)
    b, s, d = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]

    cache = init_cache(cfg, b, max_seq, device=dev)
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            p = period_params[f"pos{i}"]
            x, (k, v) = _self_attn_block(p, x, cfg, positions)
            entry = cache[f"pos{i}"]
            if cfg.kv_dtype == "int8":
                for name, t in (("k", k), ("v", v)):
                    codes, scale = _quant_kv(t)
                    entry[name][period, :, :s] = codes
                    entry[f"{name}_scale"][period, :, :s] = scale
                    # The reference quantizes the zero-padded rows too;
                    # their scale is the floor.
                    entry[f"{name}_scale"][period, :, s:] = KV_SCALE_FLOOR
            else:
                entry["k"][period, :, :s] = k.to(entry["k"].dtype)
                entry["v"][period, :, :s] = v.to(entry["v"].dtype)
            x, aux = _ffn_block(p, x, cfg, spec, collect=collect_trace,
                                mat=mat, quant_execution=quant_execution,
                                policy=policy,
                                force_high_bit=policy is not None)
            if aux is not None:
                row.append(aux)
        aux_rows.append(row)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x[:, -1])
    cache["pos"] = torch.tensor(s, dtype=torch.int64, device=dev)
    stacked = _stack_aux(aux_rows)
    aux = {"moe": stacked} if stacked else {}
    return logits, cache, aux


# ==========================================================================
# Decode step
# ==========================================================================
@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, *, collect_trace: bool = False,
                policy=None,
                policy_state: Optional[dict] = None,
                alpha=None,
                mat=None,
                token_mask: Optional[torch.Tensor] = None,
                quant_execution: Optional[bool] = None):
    """One decode step.  token: [B] int.  Returns (logits, cache, aux).

    ``policy_state[f"pos{i}"]`` holds the engine's residency masks
    ``{'cached_msb', 'cached_lsb'}: [n_periods, E]``; ``alpha`` is the
    Cache-Prior boost broadcast to every MoE layer; ``token_mask`` ([B]
    bool) excludes padding rows from MoE routing and capacity.

    ``cache["pos"]`` is a scalar (all sequences aligned) or a ``[B]``
    vector of per-sequence lengths (continuous batching): each sequence
    writes its KV row at its own offset and attends over its own prefix.
    The rows are written into the cache tensors in place.
    """
    b = token.shape[0]
    pos = cache["pos"]
    vector_pos = pos.ndim == 1
    x = params["embed"][token].to(_dt(cfg))[:, None, :]       # [B, 1, d]
    positions = pos[:, None] if vector_pos else pos.reshape(1, 1)
    rows = torch.arange(b, device=x.device)

    new_cache = {"pos": pos + 1}
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            key = f"pos{i}"
            p = period_params[key]
            h = L.rms_norm(x, p["norm"], cfg.norm_eps)
            q, k, v = _attn_qkv(p, h, cfg)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            entry = cache[key]

            def write_row(name, val):
                # val: [B, 1, ...], the new token's row per sequence.
                buf = entry[name][period]                   # [B, S, ...]
                if vector_pos:
                    buf[rows, pos] = val[:, 0].to(buf.dtype)
                else:
                    buf[:, pos.reshape(1)] = val.to(buf.dtype)
                return buf

            if cfg.kv_dtype == "int8":
                (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
                kc = _dequant_kv(write_row("k", kq),
                                 write_row("k_scale", ks), _dt(cfg))
                vc = _dequant_kv(write_row("v", vq),
                                 write_row("v_scale", vs), _dt(cfg))
            else:
                kc = write_row("k", k)                      # [B, S, Hkv, D]
                vc = write_row("v", v)
            new_cache[key] = entry
            o = L.decode_attention(q[:, 0], kc, vc, pos + 1)
            x = x + (o.reshape(b, -1) @ p["wo"])[:, None, :]

            ps = None
            if policy_state is not None:
                ps = {n: t[period] for n, t in policy_state[key].items()}
                if alpha is not None:
                    ps["alpha"] = alpha
            x, aux = _ffn_block(p, x, cfg, spec, collect=collect_trace,
                                policy=policy, policy_state=ps, mat=mat,
                                token_mask=token_mask,
                                quant_execution=quant_execution)
            if aux is not None:
                row.append(aux)
        aux_rows.append(row)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x[:, 0])
    stacked = _stack_aux(aux_rows)
    aux = {"moe": stacked} if stacked else {}
    return logits, new_cache, aux


# ==========================================================================
# Convenience
# ==========================================================================
def tree_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, QuantizedTensor):
        yield from (tree.codes, tree.scales, tree.zero_points)
    else:
        yield tree


def count_params(params: dict) -> int:
    return sum(int(np.prod(t.shape)) for t in tree_leaves(params))
