"""Model stack for all six architecture families (port of
``repro.models.model``): ``dense`` and ``moe`` decoders, ``ssm`` stacks
(Mamba2), ``hybrid`` interleaves (Jamba), the ``vlm`` backbone with its
embedding-prefix stub (InternVL2) and the ``audio`` encoder-decoder with
its frame stub (Whisper).

Parameters keep the reference's tree and its stacked ``[n_periods, ...]``
layout (``blocks/pos{i}/...``), so :mod:`repro_torch.bridge` maps the JAX
package's parameters onto the port one leaf to one leaf.  The reference
``lax.scan``s over periods; here a Python loop indexes each period's
slice (a view, no copy).  Layers follow ``cfg.block_pattern``: each
position's mixer is attention (``attn``) or the Mamba2 SSD mixer
(``ssm``, :mod:`repro_torch.models.ssm`), its FFN dense, MoE or none.
``mamba2-2.7b`` is a pattern of one SSM position without FFN; Jamba's is
8 long, attention at position 3, MoE FFNs at the odd positions.

The two stubs stand in for frontends the system does not model.  The
VLM's vision encoder and projector are replaced by ``prefix_embeds``
[B, prefix_len, d_model], precomputed patch embeddings that
``embed_inputs`` puts before the token embeddings when ``cfg.prefix_len``
is set and the argument is given (without it a prefix config runs on
text only); ``lm_loss`` drops the prefix positions, and ``prefill``
counts them in the cache position.  Whisper's mel and conv frontend is
replaced by ``encoder_frames`` [B, encoder_seq, d_model]: ``_encode``
runs them, cast to the model dtype, through ``encoder_layers``
non-causal attention + dense blocks with RoPE and a final norm; every
decoder attention block then adds a cross-attention (``c_``-prefixed
leaves, ``_cross_attn_block``: no RoPE, no mask) over K/V projected from
the normed encoder output (``_enc_kv``).  ``prefill`` stores those
cross K/V in the cache as ``ck`` / ``cv`` [n_periods, B, encoder_seq,
Hkv, hd] in the model dtype (int8 KV too), and ``decode_step`` reads
them from there; its ``encoder_frames`` keyword is accepted and unused,
as in the reference.  An encoder-decoder config without frames raises a
``ValueError`` in ``forward`` and ``prefill``, where the reference
asserts.  The reference builds ``c_bq`` / ``c_bk`` / ``c_bv`` leaves
under ``qkv_bias`` and never reads them; so does the port.

Public entry points: ``param_shapes`` / ``init_params``, ``embed_inputs``,
``forward`` (full sequence, differentiable over float experts; on AMAT
experts with ``mat`` and, with ``quant_execution``, through the batched
expert kernels), ``lm_loss`` (chunked cross-entropy plus the MoE
load-balance loss), ``unembed``, ``init_cache``, ``prefill``,
``decode_step`` (scalar and ``[B]`` positions, ``token_mask``, the
engine's per-position ``use_lsb`` / ``gate_override`` / ``policy_state``),
``count_params``.  The MoE aux of a pattern that mixes dense and MoE FFNs
comes from the MoE positions only, stacked ``[n_periods, n_moe_pos,
...]``.  Every self-attention takes the config's ``logit_softcap``;
``use_window`` (or ``always_swa``) limits it to the config's
``sliding_window``, and a windowed decode step with aligned positions
reads only the last ``sliding_window`` cache rows.  ``tie_embeddings``
unembeds with the embedding table (no ``unembed`` leaf); ``pad_vocab_to``
pads the vocabulary and masks the pad columns to -1e30.  With
``kv_dtype="int8"`` the KV cache holds per-(token, head) int8 codes and
f32 scales (``_quant_kv`` / ``_dequant_kv``), dequantized to the model
dtype before each decode attention.  An SSM position's cache entry holds
``state`` [n_periods, B, H, head_dim, d_state] in f32 and ``conv``
[n_periods, B, d_conv - 1, conv_channels] in the model dtype; its
``A_log``, ``D`` and ``dt_bias`` leaves stay f32 in a bf16 model, as in
the reference.  The reference wraps each period of ``forward`` in
``jax.checkpoint`` (remat); that changes memory, not values, and is not
ported.

Two serving variants.  ``quantized_serve`` stores every MoE layer's
experts as flat AMAT leaves ``{wi,wo}_{codes,scales,zps}``
(:func:`repro_torch.models.moe.quantize_params_for_serve`, MAT84 in
``init_params``), which ``forward``, ``prefill`` and ``decode_step`` read
with their ``mat``.  ``ring_kv`` makes the KV cache a ring buffer:
``decode_step`` writes position ``pos`` at row ``pos % S`` and attends
over every resident row (at most ``pos + 1``), with no window mask; a
caller that sizes the cache at ``sliding_window`` rows or fewer gets the
windowed model with O(window) memory.  ``prefill`` writes rows from 0 as
without ring, and a prompt longer than the cache raises in both.

Departures from the functional reference: ``decode_step`` writes the new
KV row, and an SSM position's new ``state`` and ``conv`` window, into the
cache tensors in place and returns a dict holding those same tensors
(with ``pos`` advanced; ``ck`` / ``cv`` are returned as they came),
which saves device memory and keeps the buffers where a captured decode
step would find them; ``init_params`` draws each stacked leaf one period
at a time (device memory again), and draws ``conv_w`` from the port's
generator (the reference seeds it from ``hash(name)``, which depends on
the process).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.core.amat import MAT84, amat_quantize_stacked, empty_stacked
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.quant.groupquant import QuantizedTensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
LOSS_CHUNKS = 16


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _window(cfg: ModelConfig, use_window: bool) -> Optional[int]:
    return cfg.sliding_window if (use_window or cfg.always_swa) else None


# ==========================================================================
# Parameter shapes / init
# ==========================================================================
def _attn_shapes(cfg: ModelConfig, cross: bool = False) -> dict:
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
    if cross:
        sh = {("c_" + k if k != "norm" else "c_norm"): v
              for k, v in sh.items()}
    return sh


def _block_shapes(cfg: ModelConfig, spec: BlockSpec, decoder: bool) -> dict:
    if spec.mixer == "attn":
        sh = dict(_attn_shapes(cfg))
        if decoder and cfg.is_encdec:
            sh.update(_attn_shapes(cfg, cross=True))
    else:
        if cfg.ssm is None:
            raise ValueError(f"{cfg.name}: an SSM position needs an SSMCfg "
                             "(cfg.ssm is None)")
        sh = {"ssm": S.ssm_param_shapes(cfg.d_model, cfg.ssm),
              "ssm_norm": (cfg.d_model,)}
    if spec.ffn == "dense":
        sh["mlp"] = L.mlp_param_shapes(cfg.d_model, cfg.d_ff, cfg.mlp_type)
        sh["mlp_norm"] = (cfg.d_model,)
    elif spec.ffn == "moe":
        sh["moe"] = M.moe_param_shapes(cfg.d_model, cfg.moe)
        if cfg.quantized_serve:
            sh["moe"]["experts"] = M.quantized_expert_shapes(cfg.d_model,
                                                             cfg.moe)
        sh["moe_norm"] = (cfg.d_model,)
    return sh


def _stack(shapes: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of shape-tuples mirroring the param tree."""
    blocks = {f"pos{i}": _stack(_block_shapes(cfg, spec, decoder=True),
                                cfg.n_periods)
              for i, spec in enumerate(cfg.block_pattern)}
    v_embed = cfg.padded_vocab if cfg.tie_embeddings else cfg.vocab_size
    sh = {
        "embed": (v_embed, cfg.d_model),
        "blocks": blocks,
        "final_norm": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        sh["unembed"] = (cfg.d_model, cfg.padded_vocab)
    if cfg.is_encdec:
        enc_block = _block_shapes(cfg, BlockSpec("attn", "dense"),
                                  decoder=False)
        sh["encoder"] = {"blocks": _stack(enc_block, cfg.encoder_layers),
                         "final_norm": (cfg.d_model,)}
    return sh


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

    An encoder-decoder's ``encoder`` subtree and cross-attention leaves
    follow the same rule.  An SSM mixer's leaves get the reference's
    special inits: ``A_log =
    log(linspace(1, 16, H))``, ``D = 1`` and ``dt_bias = -2``, all three
    f32 in any model dtype, and ``conv_w`` normal times 0.2.

    Stacked leaves are drawn one period at a time in f32 and cast into a
    preallocated tensor of the model dtype, so the peak temporary is one
    period of one leaf, never a whole stack in f32.

    With ``quantized_serve`` the result equals ``quantize_params_for_serve(
    init_params(replace(cfg, quantized_serve=False), seed), cfg, MAT84)``
    leaf for leaf, as in the reference, but each period of ``wi`` and
    ``wo`` is quantized as it is drawn and its floats dropped, so the
    float experts are never held whole.
    """
    dev = resolve_device(device)
    dtype = _dt(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f32 = torch.float32

    def init_tree(shapes: dict, ssm: bool = False) -> dict:
        out = {}
        for k in sorted(shapes):
            v = shapes[k]
            if isinstance(v, dict) and k == "experts" and cfg.quantized_serve:
                out[k] = amat_experts(v)
            elif isinstance(v, dict):
                out[k] = init_tree(v, ssm=k == "ssm")
            elif ssm and k in ssm_init:
                out[k] = ssm_init[k](v)
            else:
                out[k] = init_one(v)
        return out

    def draws(shape, std):
        """A leaf's normal draws in f32, one period at a time for a stack:
        the order the generator is read in."""
        per = [shape[1:]] * shape[0] if len(shape) >= 3 else [shape]
        for chunk_shape in per:
            yield torch.randn(chunk_shape, generator=gen, device=dev,
                              dtype=f32).mul_(std)

    def normal(shape, std, dt):
        t = torch.zeros(shape, dtype=dt, device=dev)
        chunks = list(t) if len(shape) >= 3 else [t]
        for chunk, draw in zip(chunks, draws(shape, std)):
            chunk.copy_(draw)
        return t

    def amat_experts(shapes: dict) -> dict:
        # The float experts' draws (``init_one``), each period rounded to
        # the model dtype and quantized before the next is drawn.
        out = {}
        for name in sorted(shapes):
            shape = shapes[name]
            qt = empty_stacked(shape, MAT84, dev)
            for period, draw in enumerate(draws(shape, shape[-2] ** -0.5)):
                amat_quantize_stacked(draw.to(dtype), MAT84,
                                      out=qt.index(period))
            out[f"{name}_codes"] = qt.codes
            out[f"{name}_scales"] = qt.scales
            out[f"{name}_zps"] = qt.zero_points
        return out

    def init_one(shape):
        if len(shape) == 1 or shape[-1] == 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return normal(shape, shape[-2] ** -0.5, dtype)

    ssm_init = {
        "A_log": lambda shape: torch.log(torch.linspace(
            1.0, 16.0, shape[-1], dtype=f32, device=dev)).expand(
                shape).contiguous(),
        "D": lambda shape: torch.ones(shape, dtype=f32, device=dev),
        "dt_bias": lambda shape: torch.full(shape, -2.0, dtype=f32,
                                            device=dev),
        "conv_w": lambda shape: normal(shape, 0.2, dtype),
    }
    return init_tree(param_shapes(replace(cfg, quantized_serve=False)))


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


def _self_attn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     causal: bool, positions: torch.Tensor,
                     window: Optional[int]):
    """Self-attention over the whole sequence (causal in the decoder, not
    in the encoder) with its residual; returns (x, (k, v)) with ``k``/``v``
    after RoPE (the cache rows)."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.attention(q, k, v, causal=causal, sliding_window=window,
                    logit_softcap=cfg.logit_softcap)
    return x + o.reshape(b, s, -1) @ p["wo"], (k, v)


def _cross_attn_block(p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                      enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decoder block's cross-attention over the encoder's K/V (no RoPE,
    no mask) with its residual."""
    h = L.rms_norm(x, p["c_norm"], cfg.norm_eps)
    b, s, _ = h.shape
    q = (h @ p["c_wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    o = L.attention(q, enc_k, enc_v, causal=False,
                    logit_softcap=cfg.logit_softcap)
    return x + o.reshape(b, s, -1) @ p["c_wo"]


def _ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
               *, collect: bool, use_lsb=None, gate_override=None,
               policy=None, policy_state=None, mat=None, token_mask=None,
               quant_execution=None, force_high_bit=False):
    """The block's FFN half; returns (x, aux): the MoE layer's whole aux
    with ``collect``, else only its ``aux_loss`` and ``dropped_frac``
    (None for a dense FFN or none)."""
    if spec.ffn == "none":
        return x, None
    if spec.ffn == "dense":
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(p["mlp"], h, cfg.mlp_type), None
    h = L.rms_norm(x, p["moe_norm"], cfg.norm_eps)
    b, s, d = h.shape
    y, aux = M.moe_apply(
        p["moe"], h.reshape(-1, d), cfg.moe, use_lsb=use_lsb,
        gate_override=gate_override, policy=policy,
        policy_state=policy_state, mat=mat, token_mask=token_mask,
        quant_execution=quant_execution, force_high_bit=force_high_bit)
    if not collect:
        aux = {"aux_loss": aux["aux_loss"],
               "dropped_frac": aux["dropped_frac"]}
    return x + y.reshape(b, s, d), aux


def _ssm_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    h = L.rms_norm(x, p["ssm_norm"], cfg.norm_eps)
    return x + S.ssm_forward(p["ssm"], h, cfg.ssm)


def _stack_aux(per_period: list) -> dict:
    """[[aux per moe position] per period] -> leaves [P, n_moe_pos, ...]."""
    if not per_period or not per_period[0]:
        return {}
    keys = per_period[0][0].keys()
    return {k: torch.stack([torch.stack([a[k] for a in row])
                            for row in per_period]) for k in keys}


# ==========================================================================
# Encoder (whisper)
# ==========================================================================
def _encode(params: dict, cfg: ModelConfig,
            frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, enc_seq, d_model], precomputed frontend embeddings (a
    tensor or an array), cast to the model dtype; returns the encoder's
    output after its final norm."""
    enc = params["encoder"]
    x = torch.as_tensor(frames, device=enc["final_norm"].device).to(_dt(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    spec = BlockSpec("attn", "dense")
    for layer in range(cfg.encoder_layers):
        p = _index(enc["blocks"], layer)
        x, _ = _self_attn_block(p, x, cfg, causal=False, positions=positions,
                                window=None)
        x, _ = _ffn_block(p, x, cfg, spec, collect=False)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _enc_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """One decoder block's cross K/V from the normed encoder output."""
    b, s, _ = enc_out.shape
    k = (enc_out @ p["c_wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["c_wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _encoder_output(params: dict, cfg: ModelConfig,
                    encoder_frames) -> Optional[torch.Tensor]:
    """``_encode`` of the frames for an encoder-decoder (which must have
    them), else None."""
    if not cfg.is_encdec:
        return None
    if encoder_frames is None:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder needs encoder_frames [B, "
            "encoder_seq, d_model]")
    return _encode(params, cfg, encoder_frames)


# ==========================================================================
# Full-sequence pieces
# ==========================================================================
def embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 prefix_embeds=None) -> torch.Tensor:
    """Token embeddings in the model dtype, after ``prefix_embeds``
    [B, prefix_len, d] (a tensor or an array, cast to the model dtype)
    when the config has a prefix and the argument is given.

    The reference's ``onehot_embed`` computes the lookup as a one-hot
    product, a sharding knob for a vocabulary split over devices; the
    product adds one nonzero term per row, so it picks the same row
    exactly, and the port keeps the gather for that setting too.
    """
    x = params["embed"][tokens].to(_dt(cfg))
    if cfg.prefix_len and prefix_embeds is not None:
        prefix = torch.as_tensor(prefix_embeds, device=x.device)
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, encoder_frames=None,
            collect_trace: bool = False, use_window: bool = False,
            mat=None, quant_execution: Optional[bool] = None):
    """Full-sequence forward.  tokens: [B, S_text] int; ``prefix_embeds``
    [B, prefix_len, d] for a prefix config, ``encoder_frames`` [B,
    enc_seq, d] for an encoder-decoder (required there).  Returns (hidden
    [B, S, d] after the final norm, S counting the prefix, aux):
    ``aux["aux_loss"]`` sums the MoE
    layers' load-balance losses; ``aux["moe"]`` holds their ``aux_loss``
    and ``dropped_frac`` (with ``collect_trace`` their whole aux: ids,
    gates) stacked ``[n_periods, n_moe_pos, ...]``.  AMAT experts need
    ``mat``; ``quant_execution`` runs them through the batched expert
    kernels.  Differentiable over float weights unless run under
    ``torch.no_grad()``."""
    x = embed_inputs(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    window = _window(cfg, use_window)
    enc_out = _encoder_output(params, cfg, encoder_frames)
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            p = period_params[f"pos{i}"]
            if spec.mixer == "attn":
                x, _ = _self_attn_block(p, x, cfg, causal=True,
                                        positions=positions, window=window)
                if enc_out is not None:
                    ek, ev = _enc_kv(p, enc_out, cfg)
                    x = _cross_attn_block(p, x, ek, ev, cfg)
            else:
                x = _ssm_block(p, x, cfg)
            x, aux = _ffn_block(p, x, cfg, spec, collect=collect_trace,
                                mat=mat, quant_execution=quant_execution)
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
    """Logits in f32 over the padded vocabulary, its pad columns masked
    to -1e30 (so softmax, argmax and logsumexp ignore them)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (h @ w.to(h.dtype)).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.full_like(logits, -1e30))
    return logits


def lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, prefix_embeds=None,
            encoder_frames=None, aux_weight: float = 0.01):
    """Mean next-token cross-entropy over the flattened token stream,
    plus ``aux_weight`` times the load-balance loss; returns (loss, aux).
    The prefix positions are dropped before the loss (``labels`` cover
    the text only).  The logits are formed ``LOSS_CHUNKS`` token chunks
    at a time (one chunk when the token count does not divide), never as
    one [T, V]."""
    h, aux = forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                     encoder_frames=encoder_frames)
    if cfg.prefix_len and prefix_embeds is not None:
        h = h[:, cfg.prefix_len:]
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
@dataclass(frozen=True)
class CacheDims:
    batch: int
    max_seq: int


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
    """Decode-state tree, stacked over periods per pattern position: an
    attention position's ``k`` / ``v`` [n_periods, B, S, Hkv, hd] (with
    ``kv_dtype="int8"`` also ``k_scale`` / ``v_scale`` [n_periods, B, S,
    Hkv] f32; an encoder-decoder's also ``ck`` / ``cv`` [n_periods, B,
    encoder_seq, Hkv, hd] in ``dtype``, int8 KV or not), an SSM
    position's ``state`` [n_periods, B, H, head_dim, d_state] f32 and
    ``conv`` [n_periods, B, d_conv - 1, conv_channels]."""
    return _init_cache(cfg, batch, max_seq, dtype or _dt(cfg),
                       resolve_device(device), cfg.encoder_seq)


def _init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                dev: torch.device, encoder_seq: int) -> dict:
    """``init_cache`` with the cross K/V ``encoder_seq`` rows long (the
    frames' length, in ``prefill``)."""
    int8_kv = cfg.kv_dtype == "int8"
    cache: dict = {"pos": torch.zeros((), dtype=torch.int64, device=dev)}
    kv_shape = (cfg.n_periods, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = torch.int8 if int8_kv else dtype
    for i, spec in enumerate(cfg.block_pattern):
        if spec.mixer != "attn":
            ssm = cfg.ssm
            cache[f"pos{i}"] = {
                "state": torch.zeros(
                    (cfg.n_periods, batch, ssm.n_heads(cfg.d_model),
                     ssm.head_dim, ssm.d_state), dtype=torch.float32,
                    device=dev),
                "conv": torch.zeros(
                    (cfg.n_periods, batch, ssm.d_conv - 1,
                     ssm.conv_channels(cfg.d_model)), dtype=dtype,
                    device=dev)}
            continue
        entry = {"k": torch.zeros(kv_shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(kv_shape, dtype=kv_dt, device=dev)}
        if int8_kv:
            for name in ("k_scale", "v_scale"):
                entry[name] = torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                          device=dev)
        if cfg.is_encdec:
            cross_shape = (cfg.n_periods, batch, encoder_seq,
                           cfg.n_kv_heads, cfg.head_dim)
            for name in ("ck", "cv"):
                entry[name] = torch.zeros(cross_shape, dtype=dtype,
                                          device=dev)
        cache[f"pos{i}"] = entry
    return cache


# ==========================================================================
# Prefill
# ==========================================================================
@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, *, prefix_embeds=None, encoder_frames=None,
            collect_trace: bool = False, use_window: bool = False, mat=None,
            quant_execution: Optional[bool] = None, policy=None):
    """Forward over the prompt, returning (last-token logits, cache, aux).
    The cache position counts the prefix; an encoder-decoder's cache
    holds each decoder block's cross K/V of ``encoder_frames``.  The
    prompt fills rows from 0, ring buffer or not; a prompt longer than
    ``max_seq`` raises a ``ValueError`` when the model has attention.

    ``policy``: optional *state-free* RoutingPolicy (cumsum) to route the
    prompt with; compute stays high-bit for every routed expert.
    """
    x = embed_inputs(params, cfg, tokens, prefix_embeds)
    b, s, d = x.shape
    if s > max_seq and cfg.has_attention:
        # The reference's pad to max_seq rows raises here too.
        raise ValueError(f"{cfg.name}: a prompt of {s} positions does not "
                         f"fit a KV cache of max_seq={max_seq} rows")
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    window = _window(cfg, use_window)
    enc_out = _encoder_output(params, cfg, encoder_frames)

    cache = _init_cache(cfg, b, max_seq, _dt(cfg), dev,
                        cfg.encoder_seq if enc_out is None
                        else enc_out.shape[1])
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            p = period_params[f"pos{i}"]
            entry = cache[f"pos{i}"]
            if spec.mixer != "attn":
                h = L.rms_norm(x, p["ssm_norm"], cfg.norm_eps)
                y, (state, tail) = S.ssm_forward(p["ssm"], h, cfg.ssm,
                                                 return_state=True)
                x = x + y
                entry["state"][period] = state
                entry["conv"][period] = tail.to(entry["conv"].dtype)
            else:
                x, (k, v) = _self_attn_block(p, x, cfg, causal=True,
                                             positions=positions,
                                             window=window)
                if cfg.kv_dtype == "int8":
                    for name, t in (("k", k), ("v", v)):
                        codes, scale = _quant_kv(t)
                        entry[name][period, :, :s] = codes
                        entry[f"{name}_scale"][period, :, :s] = scale
                        # The reference quantizes the zero-padded rows
                        # too; their scale is the floor.
                        entry[f"{name}_scale"][period, :, s:] = \
                            KV_SCALE_FLOOR
                else:
                    entry["k"][period, :, :s] = k.to(entry["k"].dtype)
                    entry["v"][period, :, :s] = v.to(entry["v"].dtype)
                if enc_out is not None:
                    ek, ev = _enc_kv(p, enc_out, cfg)
                    x = _cross_attn_block(p, x, ek, ev, cfg)
                    entry["ck"][period] = ek.to(entry["ck"].dtype)
                    entry["cv"][period] = ev.to(entry["cv"].dtype)
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
def _attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, entry: dict,
                 period: int, pos: torch.Tensor, positions: torch.Tensor,
                 rows: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """One attention position of a decode step with its residual: writes
    the new K/V row of period ``period`` into ``entry`` in place, then
    attends over the cache (``pos``: scalar or ``[B]``; ``rows``:
    ``arange(B)``)."""
    b = x.shape[0]
    vector_pos = pos.ndim == 1
    ring = cfg.ring_kv
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    s_cache = entry["k"].shape[2]
    pos_w = pos % s_cache if ring else pos

    def write_row(name, val):
        # val: [B, 1, ...], the new token's row per sequence.
        buf = entry[name][period]                           # [B, S, ...]
        if vector_pos and ring:
            buf[rows, pos_w] = val[:, 0].to(buf.dtype)
        elif vector_pos:
            # A row at or past the cache's end (an idle slot's position
            # keeps counting) is dropped, as the reference's scatter
            # drops it; no host sync.
            at = pos.clamp(max=buf.shape[1] - 1)
            keep = (pos < buf.shape[1]).reshape(
                (b,) + (1,) * (buf.ndim - 2))
            buf[rows, at] = torch.where(
                keep, val[:, 0].to(buf.dtype), buf[rows, at])
        else:
            buf[:, pos_w.reshape(1)] = val.to(buf.dtype)
        return buf

    if cfg.kv_dtype == "int8":
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        bufs = [write_row(n, t) for n, t in (
            ("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))]
    else:
        bufs = [write_row("k", k), write_row("v", v)]

    # A ring buffer holds only rows within the window: attend over every
    # resident row (attention is permutation-invariant, so the wrap's
    # order does not matter).  Otherwise a windowed step at aligned
    # positions reads only the last `window` cache rows (O(window)
    # traffic, not a masked full read); per-sequence positions read the
    # full cache and let decode_attention's per-row mask bound each
    # window.
    cur, win_mask = pos + 1, window
    if ring:
        cur, win_mask = torch.clamp(pos + 1, max=s_cache), None
    elif not vector_pos and window is not None and s_cache > window:
        start = torch.clamp(pos + 1 - window, 0, s_cache - window)
        idx = start + torch.arange(window, device=x.device)
        bufs = [t.index_select(1, idx) for t in bufs]
        cur, win_mask = pos + 1 - start, None
    if cfg.kv_dtype == "int8":
        kc = _dequant_kv(bufs[0], bufs[2], _dt(cfg))
        vc = _dequant_kv(bufs[1], bufs[3], _dt(cfg))
    else:
        kc, vc = bufs
    o = L.decode_attention(q[:, 0], kc, vc, cur, sliding_window=win_mask,
                           logit_softcap=cfg.logit_softcap)
    return x + (o.reshape(b, -1) @ p["wo"])[:, None, :]


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, *, encoder_frames=None,
                collect_trace: bool = False,
                use_lsb: Optional[dict] = None,
                gate_override: Optional[dict] = None,
                policy=None,
                policy_state: Optional[dict] = None,
                alpha=None,
                mat=None,
                token_mask: Optional[torch.Tensor] = None,
                use_window: bool = False,
                quant_execution: Optional[bool] = None):
    """One decode step.  token: [B] int.  Returns (logits, cache, aux).

    ``use_lsb`` / ``gate_override`` / ``policy_state`` are optional
    per-(position, period) overrides injected by the SliceMoE engine:
      use_lsb[f"pos{i}"]        : [n_periods, E] bool
      gate_override[f"pos{i}"]  : ([n_periods, B, k] gates, ids)
      policy_state[f"pos{i}"]   : {'cached_msb'/'cached_lsb': [n_periods, E]}
    ``alpha`` is the Cache-Prior boost broadcast to every MoE layer;
    ``token_mask`` ([B] bool) excludes padding rows from MoE routing and
    capacity.  ``encoder_frames`` is accepted and unused, as in the
    reference: an encoder-decoder's cross-attention reads the ``ck`` /
    ``cv`` that ``prefill`` stored, and the step returns those same
    tensors.

    ``cache["pos"]`` is a scalar (all sequences aligned) or a ``[B]``
    vector of per-sequence lengths (continuous batching): each sequence
    writes its KV row at its own offset and attends over its own prefix.
    The rows are written into the cache tensors in place, and so are an
    SSM position's new ``state`` and ``conv`` window (every sequence's,
    whatever its position or mask, as in the reference).  With a window
    (``use_window`` or ``always_swa``) and a scalar position, attention
    reads only the last ``sliding_window`` cache rows when the cache is
    longer than that; with vector positions it reads the whole cache
    under the window's mask.  With ``ring_kv`` a sequence's row is
    ``pos % S`` (every slot's, idle ones too, as in the reference), and
    attention reads every resident row with no window mask.
    """
    b = token.shape[0]
    pos = cache["pos"]
    vector_pos = pos.ndim == 1
    x = params["embed"][token].to(_dt(cfg))[:, None, :]       # [B, 1, d]
    positions = pos[:, None] if vector_pos else pos.reshape(1, 1)
    rows = torch.arange(b, device=x.device)
    window = _window(cfg, use_window)

    def per_period(overrides, key, period):
        if overrides is None or key not in overrides:
            return None
        v = overrides[key]
        if isinstance(v, (tuple, list)):
            return tuple(t[period] for t in v)
        return v[period]

    new_cache = {"pos": pos + 1}
    aux_rows = []
    for period in range(cfg.n_periods):
        period_params = _index(params["blocks"], period)
        row = []
        for i, spec in enumerate(cfg.block_pattern):
            key = f"pos{i}"
            p = period_params[key]
            entry = cache[key]
            if spec.mixer == "attn":
                x = _attn_decode(p, x, cfg, entry, period, pos, positions,
                                 rows, window)
                if cfg.is_encdec:
                    x = _cross_attn_block(p, x, entry["ck"][period],
                                          entry["cv"][period], cfg)
            else:
                h = L.rms_norm(x, p["ssm_norm"], cfg.norm_eps)
                state, conv = entry["state"][period], entry["conv"][period]
                y, new_state, new_conv = S.ssm_decode_step(
                    p["ssm"], h[:, 0], state, conv, cfg.ssm)
                state.copy_(new_state)
                conv.copy_(new_conv)
                x = x + y[:, None, :]
            new_cache[key] = entry

            ps = None
            if policy_state is not None and key in policy_state:
                ps = {n: t[period] for n, t in policy_state[key].items()}
                if alpha is not None:
                    ps["alpha"] = alpha
            x, aux = _ffn_block(p, x, cfg, spec, collect=collect_trace,
                                use_lsb=per_period(use_lsb, key, period),
                                gate_override=per_period(gate_override, key,
                                                         period),
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
