"""How far two AdamW runs can part when their gradients agree only to a
tolerance (shared by the train-step parity tests; imports no JAX)."""

import numpy as np

from repro_torch.optim import adamw as TO


def divergence_bound(opt_cfg, n_steps: int) -> float:
    """Worst-case per-entry distance between two AdamW runs whose
    gradients differ only within the gradient tolerance.

    An entry whose gradient lies within its tolerance of zero may take
    the other sign in the other run; AdamW then moves it the other way.
    Each step moves an entry by ``lr_t * |m_hat| / sqrt(v_hat)`` plus
    weight decay, and ``|m_hat| / sqrt(v_hat) <= B_t`` (Cauchy-Schwarz
    over the moment weights), so two runs part by at most
    ``D_{t+1} = D_t * (1 + lr_t * wd) + 2 * lr_t * B_t``.
    """
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    d = 0.0
    for t in range(1, n_steps + 1):
        a = [(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)]
        c = [(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)]
        bt = np.sqrt(sum(x * x / y for x, y in zip(a, c))) \
            * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        lr = TO.schedule_lr(opt_cfg, t - 1)
        d = d * (1 + lr * opt_cfg.weight_decay) + 2 * lr * bt
    return d


# Entries beyond 1e-6 after the steps may be at most this share of all:
# those whose gradient cancels to near zero, where the normalized AdamW
# step takes either sign (0.11-0.15% measured on the 2-layer f32 repro
# models after three steps, CPU against the reference).
MAX_SHARE_OFF = 0.005
