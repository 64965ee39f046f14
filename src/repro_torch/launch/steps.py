"""The train step (port of ``make_train_step`` in ``repro.launch.steps``),
for every architecture: a batch's ``prefix_embeds`` and
``encoder_frames`` go to ``lm_loss`` with its tokens.

The reference's other step factories (prefill, decode, dry-run shapes)
belong to ROADMAP.md queue 1, 'Launch and dry-run, last'.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
