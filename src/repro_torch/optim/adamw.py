"""AdamW optimizer + schedules (port of ``repro.optim.adamw``).

Mixed-precision convention as in the reference: model params may be bf16;
the optimizer keeps f32 first/second moments and (optionally) an f32
master copy, applies updates in f32 and casts back to the param dtype.
Weight decay applies to leaves with ``ndim >= 2`` (the reference's rule,
which on the stacked ``[n_periods, ...]`` layout includes norm scales).

One departure, to save device memory: ``apply_updates`` writes the new
values into the parameter, moment and master tensors in place (under
``torch.no_grad()``) and returns those same objects.  Trees are nested
dicts of tensors, walked in the reference's leaf order (sorted keys).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.model import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"        # 'cosine' | 'linear' | 'constant'
    master_f32: bool = True


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict
    master: Optional[dict]


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, called in sorted-key order
    (the order of :func:`tree_leaves`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def init_state(params: dict, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params) if cfg.master_f32 else None
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params), master=master)


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at ``step``, in f32 arithmetic as the reference
    computes it."""
    f32 = np.float32
    s = f32(step)
    warm = np.minimum(f32(1.0), (s + f32(1.0)) / f32(max(cfg.warmup_steps, 1)))
    if cfg.schedule == "constant":
        decay = f32(1.0)
    else:
        frac = np.clip((s - f32(cfg.warmup_steps))
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        if cfg.schedule == "linear":
            decay = f32(1.0) - f32(0.9) * frac
        else:  # cosine
            decay = f32(0.1) + f32(0.45) * (f32(1.0)
                                           + np.cos(f32(np.pi) * frac))
    return float(f32(cfg.lr) * warm * decay)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, new_state, metrics);
    ``metrics["grad_norm"]`` stays a device tensor (no host sync)."""
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0) \
        if cfg.grad_clip > 0 else None
    lr = schedule_lr(cfg, state.step)
    t = np.float32(state.step + 1)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)

    masters = tree_leaves(state.master) if state.master is not None \
        else itertools.repeat(None)
    for p, g, m, v, pm in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu),
                              masters):
        # The reference's expressions, rounding step for rounding step;
        # in-place forms keep the f32 temporaries to a few per leaf.
        g = g.to(torch.float32)
        if clip is not None:
            g = g * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = m / bc1
        den = v / bc2
        upd.div_(den.sqrt_().add_(cfg.eps))
        del den
        base = pm if pm is not None else p.to(torch.float32)
        if cfg.weight_decay > 0 and p.ndim >= 2:
            upd.add_(cfg.weight_decay * base)
        new_master = base.sub_(upd.mul_(lr)) if pm is not None \
            else base - upd.mul_(lr)
        del upd
        p.copy_(new_master)

    new_state = AdamWState(step=state.step + 1, mu=state.mu, nu=state.nu,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
