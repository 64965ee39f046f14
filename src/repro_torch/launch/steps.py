"""Step functions run by the dry-run and the entry points (port of
``repro.launch.steps``).

One factory per shape kind, with the reference's features wired in: the
MoE aux loss in training (every architecture: a batch's
``prefix_embeds`` and ``encoder_frames`` go to ``lm_loss`` with its
tokens), sliding-window attention for long-context decode on dense
archs, AMAT-quantized expert decode (``MatConfig(8, 4)``) under
``quantized_serve``.  None sets ``quant_execution``, as in the
reference, so no step launches a kernel of ``repro_torch.kernels``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as MDL
from repro_torch.optim import adamw as OPT


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss with its MoE aux term, autograd backward, one
    AdamW update (in place).  ``batch``: ``tokens`` and ``labels`` [B, S]
    int on the params' device, and ``prefix_embeds`` / ``encoder_frames``
    where the config takes them.  Metrics ``loss``, ``aux_loss`` and
    ``grad_norm`` are device scalars; ``lr`` is a float."""

    def train_step(params, opt_state, batch):
        leaves = list(OPT.tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = MDL.lm_loss(
            params, cfg, batch["tokens"], batch["labels"],
            prefix_embeds=batch.get("prefix_embeds"),
            encoder_frames=batch.get("encoder_frames"))
        flat = iter(torch.autograd.grad(loss, leaves))
        for p in leaves:
            p.requires_grad_(False)
        grads = OPT.tree_map(lambda _: next(flat), params)
        params, opt_state, opt_metrics = OPT.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss.detach(), "aux_loss": aux["aux_loss"].detach(),
                   **opt_metrics}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      use_window: bool = False):
    """``prefill_step(params, batch) -> (last-token logits, cache)`` with a
    cache of ``shape.seq_len`` rows."""
    max_seq = shape.seq_len

    def prefill_step(params, batch):
        logits, cache, _ = MDL.prefill(
            params, cfg, batch["tokens"], max_seq,
            prefix_embeds=batch.get("prefix_embeds"),
            encoder_frames=batch.get("encoder_frames"),
            use_window=use_window)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, use_window: bool = False):
    """``serve_step(params, cache, token, extras) -> (next_token int32,
    logits, cache)``: one greedy decode step."""
    mat = None
    if cfg.quantized_serve:
        from repro_torch.core.amat import MatConfig
        mat = MatConfig(8, 4)

    def serve_step(params, cache, token, extras):
        logits, cache, _ = MDL.decode_step(
            params, cfg, token, cache,
            encoder_frames=extras.get("encoder_frames"),
            use_window=use_window, mat=mat)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return serve_step


def step_for_shape(cfg: ModelConfig, shape: ShapeConfig,
                   opt_cfg: Optional[OPT.AdamWConfig] = None):
    """(fn, donate_argnums) for the shape kind.

    long_500k on dense archs uses the sliding-window attention variant;
    SSM/hybrid archs run their native sub-quadratic path.  The donate
    tuples are the reference's, which lets XLA reuse the donated
    buffers; the port's steps already write the optimizer state, the
    parameters and the cache in place, so the tuple changes nothing here.
    """
    use_window = (shape.name == "long_500k"
                  and cfg.sliding_window is not None
                  and cfg.arch_type not in ("ssm",))
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg or OPT.AdamWConfig()), (0, 1)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, use_window), ()
    if shape.kind == "decode":
        return make_decode_step(cfg, use_window), (1,)
    raise ValueError(shape.kind)


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(supported, reason).  The reference's documented skips."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch without sliding-window variant "
                       "— long_500k skipped per DESIGN.md §4")
    return True, ""
