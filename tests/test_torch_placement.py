"""Port parity: expert placement policies (``repro_torch.core.placement``),
migration on the sharded cache and placement replays.

Each scenario mirrors one of the reference's ``tests/test_placement.py``
cases, runs on both packages through ``_torch_parity.run_both`` (owner
tables, replication masks, moves and migration events exact, floats at
rtol 1e-6) and keeps the reference test's own assertions on the port's
result.  The golden-trace cases replay ``tests/data/golden_trace.npz``
loaded by each package.  Model-free: no forward pass runs.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from _torch_parity import PORT, assert_same, report_view, run_both

DATA = pathlib.Path(__file__).resolve().parent / "data"

L, E = 3, 12


def _hot(seed=0, shape=(L, E)):
    return np.random.default_rng(seed).gamma(0.5, size=shape)


def _map_view(pm):
    return {"owner": pm.owner, "replicated": pm.replicated,
            "n_shards": pm.n_shards}


# --------------------------------------------------------------------------
# PlacementMap + policies
# --------------------------------------------------------------------------
def sc_round_robin_table(m):
    out = []
    for S in (1, 2, 3, 4):
        pm = m.placement.PlacementMap.round_robin(L, E, S)
        for l in range(L):
            assert np.array_equal(pm.owner_row(l),
                                  m.shard.expert_placement(E, S))
        assert not pm.replicated.any()
        out.append([_map_view(pm),
                    [pm.shards_of(l, e) for l in range(L) for e in range(E)]])
    return out


def _coverage(seed, S):
    def sc(m):
        pm = m.placement.HotnessPlacement(L, E, S, replicate_k=3).replace(
            _hot(seed))
        assert pm.owner.min() >= 0 and pm.owner.max() < S
        shards = []
        for l in range(L):
            covered = sorted(e for s in range(S)
                             for e in pm.experts_of_shard(l, s))
            n_rep = int(pm.replicated_row(l).sum())
            assert len(covered) == E + n_rep * (S - 1)
            assert sorted(set(covered)) == list(range(E))
            shards.append([pm.experts_of_shard(l, s) for s in range(S)])
        return [_map_view(pm), shards]
    return sc


def sc_shards_of_owner_first(m):
    owner = np.zeros((1, 2), np.int64)
    owner[0, 1] = 2
    rep = np.zeros((1, 2), bool)
    rep[0, 1] = True
    pm = m.placement.PlacementMap(owner=owner, replicated=rep, n_shards=3)
    assert pm.shards_of(0, 1) == (2, 0, 1)
    return [pm.shards_of(0, 0), pm.shards_of(0, 1), pm.is_replicated(0, 1)]


def sc_rejects_bad_maps(m):
    raised = []
    for owner, rep in ((np.full((1, 2), 5, np.int64), np.zeros((1, 2), bool)),
                       (np.zeros((1, 2), np.int64), np.zeros((1, 3), bool))):
        with pytest.raises(ValueError) as info:
            m.placement.PlacementMap(owner=owner, replicated=rep, n_shards=2)
        raised.append(str(info.value))
    return raised


def sc_equality_is_by_table(m):
    a = m.placement.PlacementMap.round_robin(L, E, 4)
    b = m.placement.PlacementMap.round_robin(L, E, 4)
    h = m.placement.HotnessPlacement(L, E, 4).replace(_hot())
    assert a == b and a is not b and a != h
    return [a == b, a == h, _map_view(h)]


def sc_zero_hotness_is_round_robin(m):
    for S in (1, 2, 3, 4):
        pol = m.placement.HotnessPlacement(L, E, S)
        assert pol.initial() == m.placement.PlacementMap.round_robin(L, E, S)
        assert pol.replace(np.zeros((L, E))) == pol.initial()
    return [m.placement.HotnessPlacement(L, E, 4).name,
            m.placement.RoundRobinPlacement(L, E, 4).migrates]


def sc_hotness_balances_load(m):
    hot = _hot(3) ** 3
    pm = m.placement.HotnessPlacement(L, E, 4).replace(hot)
    rr = m.placement.PlacementMap.round_robin(L, E, 4)

    def spread(p):
        return max(max(loads) - min(loads) for loads in (
            [hot[l][p.owner_row(l) == s].sum() for s in range(4)]
            for l in range(L)))

    assert spread(pm) < spread(rr)
    return [_map_view(pm), spread(pm), spread(rr)]


def sc_hotness_deterministic(m):
    pol = m.placement.HotnessPlacement(L, E, 4, replicate_k=2)
    a, b = pol.replace(_hot(5)), pol.replace(_hot(5))
    assert a == b
    return _map_view(a)


def sc_replicates_hottest_pairs(m):
    hot = np.zeros((L, E))
    hot[1, 4], hot[2, 7], hot[0, 0] = 9.0, 5.0, 3.0
    pm = m.placement.HotnessPlacement(L, E, 4, replicate_k=2).replace(hot)
    assert pm.is_replicated(1, 4) and pm.is_replicated(2, 7)
    assert int(pm.replicated.sum()) == 2
    one = m.placement.HotnessPlacement(L, E, 1, replicate_k=2).replace(hot)
    assert not one.replicated.any()
    return [_map_view(pm), _map_view(one)]


def sc_hotness_rejects_bad_input(m):
    with pytest.raises(ValueError):
        m.placement.HotnessPlacement(L, E, 2).replace(np.zeros((L, E + 1)))
    with pytest.raises(ValueError):
        m.placement.HotnessPlacement(L, E, 2, replicate_k=-1)
    return True


# --------------------------------------------------------------------------
# spec parsing and the factory
# --------------------------------------------------------------------------
def sc_valid_specs(m):
    got = [m.placement.parse_placement_spec(s) for s in
           ("round_robin", "hotness", "hotness+replicate:3", "")]
    assert got == [("round_robin", 0), ("hotness", 0), ("hotness", 3),
                   ("round_robin", 0)]
    return got


def sc_junk_specs_raise(m):
    for spec in ("junk", "hotness+replicate:", "hotness+replicate:x",
                 "hotness+replicate:0", "hotness+replicate:-1"):
        with pytest.raises(ValueError):
            m.placement.parse_placement_spec(spec)
    return True


def sc_factory_and_override(m):
    rr = m.placement.build_placement_policy("round_robin", L, E, 2)
    assert isinstance(rr, m.placement.RoundRobinPlacement)
    a = m.placement.build_placement_policy("hotness+replicate:3", L, E, 2)
    b = m.placement.build_placement_policy("hotness+replicate:3", L, E, 2,
                                           replicate_k=1)
    assert a.replicate_k == 3 and b.replicate_k == 1
    assert b.name == "hotness+replicate:1"
    with pytest.raises(ValueError):
        m.placement.build_placement_policy("round_robin", L, E, 2,
                                           replicate_k=2)
    return [rr.name, a.name, b.name, a.migrates, rr.migrates]


# --------------------------------------------------------------------------
# migration mechanics on the sharded cache
# --------------------------------------------------------------------------
def _cache(m, S=2, cap=4000.0):
    c = m.shard.ShardedSliceCache(
        cap, S, placement=m.placement.PlacementMap.round_robin(1, E, S))
    for e in range(6):
        c.insert(m.SliceKey(0, e, "msb"), 100.0 + e)
    return c


def sc_moves_conserve_bytes(m):
    c = _cache(m)
    used = c.used
    new_map = m.placement.PlacementMap(
        owner=1 - m.placement.PlacementMap.round_robin(1, E, 2).owner,
        replicated=np.zeros((1, E), bool), n_shards=2)
    moves = c.apply_placement(new_map)
    assert c.placement is new_map and len(moves) == 6 and c.used == used
    for key, nb, src, dst in moves:
        assert nb == 100.0 + key.expert
        assert dst == new_map.owner_of(key.layer, key.expert) != src
        assert c.shards[dst].contains(key)
    return moves


def sc_noop_when_unchanged(m):
    c = _cache(m)
    assert c.apply_placement(c.placement) == []
    return sorted(c.resident_keys())


def sc_replicated_slices_stay(m):
    c = _cache(m)
    rep = np.zeros((1, E), bool)
    rep[0, :6] = True
    new_map = m.placement.PlacementMap(
        owner=1 - m.placement.PlacementMap.round_robin(1, E, 2).owner,
        replicated=rep, n_shards=2)
    assert c.apply_placement(new_map) == []
    return [sorted(s.resident_keys()) for s in c.shards]


def sc_existing_copy_frees(m):
    c = _cache(m)
    c.shards[1].insert(m.SliceKey(0, 0, "msb"), 100.0)
    owner = m.placement.PlacementMap.round_robin(1, E, 2).owner.copy()
    owner[0, 0] = 1
    moves = c.apply_placement(m.placement.PlacementMap(
        owner=owner, replicated=np.zeros((1, E), bool), n_shards=2))
    assert all(k.expert != 0 for k, *_ in moves)
    assert not c.shards[0].contains(m.SliceKey(0, 0, "msb"))
    return [moves, [sorted(s.resident_keys()) for s in c.shards]]


def sc_aggregate_stats(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(800.0, 2)
    for e in range(4):
        c.access(K(0, e, "msb"), 50.0)
    c.access(K(0, 0, "msb"), 50.0)
    c.access(K(0, 1, "msb"), 50.0)
    st = c.stats
    comb = st.combined()
    assert isinstance(comb, m.cache.CacheStats)
    assert (comb.accesses, comb.misses) == (6, 4)
    assert st.snapshot() == comb.snapshot()
    out = [st.snapshot(), st.miss_rate]
    st.reset()
    assert c.stats.accesses == 0
    return out


def sc_epoch_skew_raises(m):
    c = m.shard.ShardedSliceCache(800.0, 2)
    c.begin_epoch("w0")
    c.access(m.SliceKey(0, 0, "msb"), 50.0)
    c.access(m.SliceKey(0, 1, "msb"), 50.0)
    c.end_epoch()
    aligned = c.epoch_counts()
    assert aligned == [("w0", 2, 2)]
    _, snap = c.shards[1].epochs[0]
    c.shards[1].epochs[0] = ("skewed", snap)
    with pytest.raises(RuntimeError, match="epoch skew"):
        _ = c.epochs
    return aligned


# --------------------------------------------------------------------------
# replays of the golden trace and of synthetic traces
# --------------------------------------------------------------------------
def _golden(m):
    return m.sim.Trace.load(str(DATA / "golden_trace.npz"))


def _golden_rr(ep):
    def sc(m):
        r = m.sim.replay_trace(_golden(m), ep_shards=ep, warmup="pcw")
        assert r.migration_events is None
        assert r.ledger["migration_bytes"] == 0.0
        assert r.placement["policy"] == "round_robin"
        return report_view(r)
    return sc


def _golden_hot(spec, period):
    def sc(m):
        r = m.sim.replay_trace(_golden(m), ep_shards=4, warmup="pcw",
                               placement=spec, placement_period=period)
        assert r.migration_events
        assert r.ledger["migration_bytes"] == sum(
            e["bytes"] for e in r.migration_events)
        assert r.ledger["migration_bytes"] <= r.ledger["ici_bytes"]
        return report_view(r)
    return sc


def sc_golden_old_meta_cross_placement(m):
    g = _golden(m)
    meta_engine = dict(g.meta.engine)
    for k in ("placement", "placement_period", "replicate_k"):
        meta_engine.pop(k, None)
    old = m.sim.Trace(meta=dataclasses.replace(g.meta, engine=meta_engine),
                      events=g.events)
    return [report_view(m.sim.replay_trace(
        old, ep_shards=4, warmup="pcw", placement="hotness",
        placement_period=8))]


def _synthetic_placement(async_io, replicate_k):
    def sc(m):
        spec = m.sim.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
        tr = m.sim.zipf_trace(spec, seed=2, n_requests=3, prompt_len=6,
                              decode_steps=12,
                              engine_overrides={"async_io": async_io,
                                                "prefetch_top_m": 2})
        r = m.sim.replay_trace(tr, ep_shards=4, placement="hotness",
                               placement_period=4, replicate_k=replicate_k)
        return report_view(r)
    return sc


def sc_placement_sweep(m):
    spec = m.sim.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
    tr = m.sim.zipf_trace(spec, seed=0, n_requests=3, prompt_len=6,
                          decode_steps=12)
    results = m.autotune.sweep(tr, [
        ("rr", {"ep_shards": 4}),
        ("hot", {"ep_shards": 4, "placement": "hotness",
                 "placement_period": 4}),
        ("repl", {"ep_shards": 4, "placement": "hotness",
                  "placement_period": 4, "replicate_k": 2})])
    return [{k: v for k, v in r.row().items() if k != "steps_per_s"}
            for r in results]


SCENARIOS = {
    "round_robin_table": sc_round_robin_table,
    **{f"coverage_seed{seed}_S{S}": _coverage(seed, S)
       for seed in (0, 1, 7) for S in (2, 3, 4)},
    "shards_of_owner_first": sc_shards_of_owner_first,
    "rejects_bad_maps": sc_rejects_bad_maps,
    "equality_is_by_table": sc_equality_is_by_table,
    "zero_hotness_is_round_robin": sc_zero_hotness_is_round_robin,
    "hotness_balances_load": sc_hotness_balances_load,
    "hotness_deterministic": sc_hotness_deterministic,
    "replicates_hottest_pairs": sc_replicates_hottest_pairs,
    "hotness_rejects_bad_input": sc_hotness_rejects_bad_input,
    "valid_specs": sc_valid_specs,
    "junk_specs_raise": sc_junk_specs_raise,
    "factory_and_override": sc_factory_and_override,
    "moves_conserve_bytes": sc_moves_conserve_bytes,
    "noop_when_unchanged": sc_noop_when_unchanged,
    "replicated_slices_stay": sc_replicated_slices_stay,
    "existing_copy_frees": sc_existing_copy_frees,
    "aggregate_stats": sc_aggregate_stats,
    "epoch_skew_raises": sc_epoch_skew_raises,
    "golden_round_robin_ep2": _golden_rr(2),
    "golden_round_robin_ep4": _golden_rr(4),
    "golden_hotness": _golden_hot("hotness", 8),
    "golden_hotness_replicate3": _golden_hot("hotness+replicate:3", 8),
    "golden_old_meta_cross_placement": sc_golden_old_meta_cross_placement,
    "synthetic_hotness_replicate_sync": _synthetic_placement(False, 2),
    "synthetic_hotness_replicate_async": _synthetic_placement(True, 2),
    "placement_sweep": sc_placement_sweep,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_placement_scenario_matches_reference(name):
    run_both(SCENARIOS[name])


def test_golden_hotness_pins_the_reference_sequence():
    """The reference's pinned hotness migration sequence on the golden
    trace (ep=4, period=8), reproduced by the port's replay."""
    r = PORT.sim.replay_trace(_golden(PORT), ep_shards=4, warmup="pcw",
                              placement="hotness", placement_period=8)
    want = [(8, 12, 170496.0), (16, 9, 125952.0), (24, 6, 81408.0),
            (32, 4, 56832.0), (40, 5, 69120.0), (48, 4, 56832.0),
            (56, 4, 56832.0), (64, 4, 54912.0)]
    assert [(e["step"], e["moved"], e["bytes"])
            for e in r.migration_events] == want
    assert r.decode_misses == 262


def test_port_telemetry_summarizes_shard_balance_and_placement():
    from repro.serving.telemetry import FleetTelemetry as JF
    from repro_torch.serving.telemetry import FleetTelemetry as TF

    per_shard = [
        {"shard": 0, "accesses": 100, "misses": 30, "miss_rate": 0.30},
        {"shard": 1, "accesses": 50, "misses": 5, "miss_rate": 0.10}]
    psum = {"policy": "hotness", "period": 8, "replicated_pairs": 0,
            "n_migration_events": 2, "migrated_slices": 7,
            "migration_bytes": 1234.0}
    assert_same(JF().summary(per_shard=per_shard, placement=psum),
                TF().summary(per_shard=per_shard, placement=psum))
