"""Cache-aware routing policies (port of ``repro.core.routing``).

* ``topk_routing``        — vanilla top-k (locality-insensitive baseline).
* ``cumsum_routing``      — cumulative-threshold expert selection.
* ``cache_prior_routing`` — Cache-Prior: boost the gating scores of
  DRAM-resident experts by ``alpha`` before top-k.
* ``buddy_routing``       — BuddyMoE: a missed expert runs as its cached
  buddy (``compute_buddies`` calibrates the pairs offline).
* ``criticality``         — DBSC's single-head test on renormalized gates.

Top-k ties resolve as ``jax.lax.top_k`` resolves them, toward the lower
expert index: :func:`top_k` takes a stable descending sort and slices it
(``torch.topk`` promises no order among equal values).
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last dim,
    lower index first among equal values."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _renorm(gates: torch.Tensor) -> torch.Tensor:
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)


def topk_routing(probs: torch.Tensor, k: int):
    gates, ids = top_k(probs, k)
    return _renorm(gates), ids


def cumsum_routing(probs: torch.Tensor, tau: float, k_max: int):
    """Select experts until cumulative prob >= tau (at most k_max).

    Returns (gates [T, k_max], ids [T, k_max], active [T, k_max] bool).
    """
    p_sorted, ids = top_k(probs, k_max)
    csum = torch.cumsum(p_sorted, dim=-1)
    active = torch.cat([torch.ones_like(csum[:, :1], dtype=torch.bool),
                        csum[:, :-1] < tau], dim=-1)
    gates = _renorm(p_sorted * active)
    return gates, ids, active


def cache_prior_routing(probs: torch.Tensor, cached: torch.Tensor, alpha,
                        k: int):
    """Boost cached experts' scores: p' ∝ p * (1 + alpha * cached).

    Gate values come from the *original* probabilities: the boost only
    reorders selection.
    """
    boost = 1.0 + alpha * cached.to(probs.dtype)
    _, ids = top_k(probs * boost, k)
    gates = torch.gather(probs, -1, ids)
    return _renorm(gates), ids


def buddy_routing(probs: torch.Tensor, cached: torch.Tensor,
                  buddies: torch.Tensor, k: int):
    """BuddyMoE: substitute a missed expert with its cached "buddy".

    ``buddies``: [E] int, each expert's most interchangeable expert.
    Selection is vanilla top-k; each selected-but-uncached expert is
    replaced by its buddy iff the buddy is cached (otherwise the miss
    stands).  Gates keep the original expert's probability.
    """
    gates, ids = topk_routing(probs, k)
    buddy_ids = buddies[ids]
    use_buddy = (~cached[ids]) & cached[buddy_ids]
    return gates, torch.where(use_buddy, buddy_ids, ids)


def compute_buddies(flat_weights: torch.Tensor) -> torch.Tensor:
    """Offline buddy calibration: each expert's nearest other expert by
    weight cosine similarity.  ``flat_weights``: [E, D_flat].  Ties go to
    the lower index, as ``jnp.argmax`` resolves them."""
    w = flat_weights.to(torch.float32)
    w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-9)
    sim = w @ w.T
    sim = sim - 2.0 * torch.eye(sim.shape[0], device=sim.device)
    return torch.argmax(sim, dim=-1)


def criticality(gates: torch.Tensor, theta: float = 0.5) -> torch.Tensor:
    """DBSC single-head test on renormalized top-k gates [T, k]."""
    return gates >= theta


def one_hot(ids: torch.Tensor, n: int, dtype=torch.bool) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside ``[0, n)`` gives an all-zero row
    (``F.one_hot`` raises on one; masked tokens carry the id ``n``)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def expert_demand(ids: torch.Tensor, critical: torch.Tensor, n_experts: int):
    """Per-expert slice demand (msb_needed [E], lsb_needed [E]) bool."""
    sel = one_hot(ids, n_experts)                              # [T, k, E]
    msb = sel.any(dim=1).any(dim=0)
    lsb = (sel & critical[..., None]).any(dim=1).any(dim=0)
    return msb, lsb


class MissRateController:
    """Proportional-integral controller on the Cache-Prior boost ``alpha``.

    Measures the rolling slice miss rate over recent decode steps; above
    the target it raises alpha (pulls routing toward the cache), below it
    relaxes toward zero.  Activates after ``warmup_steps``.
    """

    def __init__(self, target_miss_rate: float, *, kp: float = 40.0,
                 ki: float = 4.0, alpha_max: float = 50.0,
                 warmup_steps: int = 10, window: int = 16):
        self.target = target_miss_rate
        self.kp, self.ki = kp, ki
        self.alpha_max = alpha_max
        self.warmup_steps = warmup_steps
        self.window = window
        self.alpha = 0.0
        self._integral = 0.0
        self._history: list[float] = []
        self._step = 0

    def update(self, step_miss_rate: float) -> float:
        self._step += 1
        self._history.append(step_miss_rate)
        if len(self._history) > self.window:
            self._history.pop(0)
        if self._step <= self.warmup_steps:
            return self.alpha
        rolling = sum(self._history) / len(self._history)
        err = rolling - self.target
        self._integral = max(0.0, self._integral + err)
        self.alpha = float(min(self.alpha_max,
                               max(0.0, self.kp * err + self.ki * self._integral)))
        return self.alpha

    @property
    def active(self) -> bool:
        return self._step > self.warmup_steps
