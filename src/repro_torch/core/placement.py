"""Expert placement as a first-class policy (a copy of
``repro.core.placement`` for the port, numpy only).

Plain expert parallelism decides ownership as ``expert % ep_shards``,
a pure modulo.  Round-robin is blind to the Zipf-like expert
hotness that dominates real MoE activation traces (MoE-Infinity, arXiv
2401.14361), so at ep=4 per-shard miss rates span 0.14–0.23: hot shards
thrash while cold shards idle.

This module makes the ownership decision a *table*, not a formula:

* :class:`PlacementMap` — an explicit ``[L, E] -> shard`` owner table
  plus a ``[L, E]`` replication mask.  Everything downstream
  (``ShardedSliceCache`` key routing, the engine's per-expert ledger
  dispatch, all-to-all accounting, telemetry) keys off this map.
* :class:`RoundRobinPlacement` — reproduces the pre-refactor modulo
  bit-identically and never migrates.
* :class:`HotnessPlacement` — greedy balanced bin-packing of
  hotness-ranked experts, recomputed periodically by the engine with
  migration bytes charged on the ``ici`` interconnect channel; with
  ``replicate_k > 0`` the k globally hottest (layer, expert) pairs are
  replicated on *every* shard so dispatch resolves to the token's home
  shard and all-to-all volume drops.

Determinism / replay fidelity: policies are pure functions of the
hotness array handed to :meth:`PlacementPolicy.replace`.  The engine
feeds them charge-path hotness (``HotnessTracker``) at decode-step
boundaries only, so a trace replay — which drives the identical charge
path — reproduces every placement decision and migration bit-for-bit
(the same argument as the SLO controller's).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "PlacementMap",
    "PlacementPolicy",
    "RoundRobinPlacement",
    "HotnessPlacement",
    "parse_placement_spec",
    "build_placement_policy",
]


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Explicit expert→shard ownership table.

    ``owner[l, e]`` is the home shard of expert ``e`` at MoE layer
    ``l``; ``replicated[l, e]`` marks experts that additionally hold a
    replica on every shard (dispatch then resolves to the token's home
    shard, so the access never crosses the interconnect).
    """

    owner: np.ndarray        # [L, E] int, values in [0, n_shards)
    replicated: np.ndarray   # [L, E] bool
    n_shards: int

    def __post_init__(self):
        owner = np.asarray(self.owner, dtype=np.int64)
        rep = np.asarray(self.replicated, dtype=bool)
        if owner.shape != rep.shape or owner.ndim != 2:
            raise ValueError(
                f"owner {owner.shape} / replicated {rep.shape} must be "
                "matching [n_layers, n_experts] tables")
        if owner.size and (owner.min() < 0 or owner.max() >= self.n_shards):
            raise ValueError(
                f"owner table references shard outside [0, {self.n_shards})")
        object.__setattr__(self, "owner", owner)
        object.__setattr__(self, "replicated", rep)

    # ------------------------------------------------------------ queries
    @property
    def n_layers(self) -> int:
        return int(self.owner.shape[0])

    @property
    def n_experts(self) -> int:
        return int(self.owner.shape[1])

    def owner_of(self, layer: int, expert: int) -> int:
        return int(self.owner[layer, expert])

    def is_replicated(self, layer: int, expert: int) -> bool:
        return bool(self.replicated[layer, expert])

    def shards_of(self, layer: int, expert: int) -> Tuple[int, ...]:
        """Every shard holding (a replica of) the expert, owner first."""
        o = self.owner_of(layer, expert)
        if not self.is_replicated(layer, expert):
            return (o,)
        return (o,) + tuple(s for s in range(self.n_shards) if s != o)

    def owner_row(self, layer: int) -> np.ndarray:
        """``[E]`` owner shard per expert at ``layer`` (read-only view)."""
        return self.owner[layer]

    def replicated_row(self, layer: int) -> np.ndarray:
        return self.replicated[layer]

    def experts_of_shard(self, layer: int, shard: int) -> List[int]:
        """Experts resident on ``shard`` at ``layer`` (owned or replica)."""
        own = np.nonzero((self.owner[layer] == shard)
                         | self.replicated[layer])[0]
        return [int(e) for e in own]

    def __eq__(self, other) -> bool:
        if not isinstance(other, PlacementMap):
            return NotImplemented
        return (self.n_shards == other.n_shards
                and np.array_equal(self.owner, other.owner)
                and np.array_equal(self.replicated, other.replicated))

    def __hash__(self):  # frozen dataclass with arrays: identity hash
        return id(self)

    # ------------------------------------------------------ constructors
    @classmethod
    def round_robin(cls, n_layers: int, n_experts: int,
                    n_shards: int) -> "PlacementMap":
        """The pre-refactor modulo, as a table: ``owner[l, e] = e % S``."""
        owner = np.tile(np.arange(n_experts, dtype=np.int64) % n_shards,
                        (n_layers, 1))
        return cls(owner=owner,
                   replicated=np.zeros((n_layers, n_experts), bool),
                   n_shards=n_shards)


class PlacementPolicy:
    """Decides the :class:`PlacementMap`; the engine owns *when* to ask.

    ``migrates`` tells the engine whether periodic re-placement is ever
    worth triggering (round_robin never changes, so the engine skips the
    hotness snapshot entirely and stays bit-identical to pre-refactor).
    """

    name: str = "base"
    migrates: bool = False

    def __init__(self, n_layers: int, n_experts: int, n_shards: int):
        self.n_layers = int(n_layers)
        self.n_experts = int(n_experts)
        self.n_shards = int(n_shards)

    def initial(self) -> PlacementMap:
        """Placement before any hotness has been observed."""
        return self.replace(np.zeros((self.n_layers, self.n_experts)))

    def replace(self, hotness: np.ndarray) -> PlacementMap:
        raise NotImplementedError


class RoundRobinPlacement(PlacementPolicy):
    """Today's behavior, bit-identical: ``owner[l, e] = e % S``, never
    re-placed, nothing replicated."""

    name = "round_robin"
    migrates = False

    def replace(self, hotness: np.ndarray) -> PlacementMap:
        return PlacementMap.round_robin(
            self.n_layers, self.n_experts, self.n_shards)


class HotnessPlacement(PlacementPolicy):
    """Greedy balanced bin-packing of hotness-ranked experts.

    Per layer, experts are visited in descending hotness (ties: lower
    expert id first) and each is assigned to the shard with the least
    accumulated hotness load — ties broken by fewest experts assigned,
    then lowest shard id.  The count tie-break makes the zero-hotness
    degenerate case collapse *exactly* to round-robin, so a cold engine
    starts from the pre-refactor placement and only diverges once the
    tracker has observed real traffic.

    With ``replicate_k > 0`` the k hottest (layer, expert) pairs across
    the whole model (ties: lower layer, then lower expert) are marked
    replicated: each shard keeps its own copy, charged against its own
    DRAM budget, and dispatch resolves to the token's home shard.
    """

    migrates = True

    def __init__(self, n_layers: int, n_experts: int, n_shards: int,
                 *, replicate_k: int = 0):
        super().__init__(n_layers, n_experts, n_shards)
        self.replicate_k = int(replicate_k)
        if self.replicate_k < 0:
            raise ValueError(f"replicate_k must be >= 0, got {replicate_k}")
        self.name = ("hotness" if not self.replicate_k
                     else f"hotness+replicate:{self.replicate_k}")

    def replace(self, hotness: np.ndarray) -> PlacementMap:
        hot = np.asarray(hotness, dtype=np.float64)
        if hot.shape != (self.n_layers, self.n_experts):
            raise ValueError(
                f"hotness shape {hot.shape} != "
                f"({self.n_layers}, {self.n_experts})")
        L, E, S = self.n_layers, self.n_experts, self.n_shards
        owner = np.zeros((L, E), dtype=np.int64)
        for l in range(L):
            # Descending hotness; np.lexsort's last key dominates, ties
            # fall through to ascending expert id for determinism.
            order = np.lexsort((np.arange(E), -hot[l]))
            load = [0.0] * S
            count = [0] * S
            for e in order:
                sid = min(range(S), key=lambda s: (load[s], count[s], s))
                owner[l, e] = sid
                load[sid] += float(hot[l, e])
                count[sid] += 1
        replicated = np.zeros((L, E), bool)
        if self.replicate_k > 0 and S > 1:
            flat = hot.reshape(-1)
            # Hottest first; ties resolve to lower (layer, expert).
            order = np.lexsort((np.arange(flat.size), -flat))
            for idx in order[: self.replicate_k]:
                replicated.reshape(-1)[idx] = True
        return PlacementMap(owner=owner, replicated=replicated, n_shards=S)


def parse_placement_spec(spec: str) -> Tuple[str, int]:
    """``"round_robin" | "hotness" | "hotness+replicate:K"`` →
    ``(policy_name, replicate_k)``.  Raises ``ValueError`` on junk."""
    s = (spec or "round_robin").strip()
    if s == "round_robin":
        return "round_robin", 0
    if s == "hotness":
        return "hotness", 0
    if s.startswith("hotness+replicate:"):
        try:
            k = int(s.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad replicate count in placement spec {spec!r}")
        if k <= 0:
            raise ValueError(
                f"replicate count must be positive in placement spec {spec!r}")
        return "hotness", k
    raise ValueError(
        f"unknown placement spec {spec!r} (expected 'round_robin', "
        "'hotness', or 'hotness+replicate:K')")


def build_placement_policy(spec: str, n_layers: int, n_experts: int,
                           n_shards: int, *,
                           replicate_k: Optional[int] = None
                           ) -> PlacementPolicy:
    """Factory: spec string (+ optional explicit replicate_k override)
    → policy instance.  ``replicate_k`` passed separately wins over a
    ``+replicate:K`` suffix so the engine-config knob stays scalar."""
    name, spec_k = parse_placement_spec(spec)
    k = spec_k if replicate_k is None else int(replicate_k)
    if name == "round_robin":
        if k:
            raise ValueError(
                "replicate_k > 0 requires the hotness placement policy")
        return RoundRobinPlacement(n_layers, n_experts, n_shards)
    return HotnessPlacement(n_layers, n_experts, n_shards, replicate_k=k)
