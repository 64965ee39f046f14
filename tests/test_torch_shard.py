"""Port parity: expert-parallel sharding (``repro_torch.core.shard``, the
sharded ledger of ``repro_torch.hw.energy`` and EP replays).

Each scenario mirrors one of the reference's ``tests/test_ep_shards.py``
cases, runs on both packages through ``_torch_parity.run_both`` (ids,
counts and placements exact, floats at rtol 1e-6) and keeps the
reference test's own assertions on the port's result.  Model-free: no
forward pass runs.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import PORT, report_view, run_both


def _spec(m):
    return m.sim.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)


def small_trace(m, seed=0, **kw):
    kw.setdefault("n_requests", 3)
    kw.setdefault("prompt_len", 6)
    kw.setdefault("decode_steps", 10)
    return m.sim.zipf_trace(_spec(m), seed=seed, **kw)


# --------------------------------------------------------------------------
# placement helpers and the all-to-all count
# --------------------------------------------------------------------------
def sc_round_robin_placement(m):
    out = {}
    for ep in (1, 2, 3, 4):
        place = m.shard.expert_placement(12, ep)
        assert all(m.shard.shard_of_expert(e, ep) == place[e]
                   for e in range(12))
        counts = np.bincount(place, minlength=ep)
        assert counts.max() - counts.min() <= 1
        out[ep] = place
    return out


def sc_all_to_all_bytes(m):
    tok = np.array([0, 0, 1, 1])
    exp = np.array([0, 1, 0, 1])
    nb = m.shard.all_to_all_bytes(tok, exp, d_model=16, n_shards=2)
    assert nb == 2 * 16 * 2
    owner = np.array([1, 1])
    rep = np.array([True, False])
    return [nb, m.shard.all_to_all_bytes(tok, exp, 16, 1),
            m.shard.all_to_all_bytes(np.empty(0, int), np.empty(0, int),
                                     16, 4),
            m.shard.all_to_all_bytes(tok, exp, 16, 2, owner_row=owner,
                                     replicated_row=rep),
            m.shard.remote_selection_mask(tok, exp, 2, owner_row=owner,
                                          replicated_row=rep)]


# --------------------------------------------------------------------------
# sharded cache
# --------------------------------------------------------------------------
def sc_cache_routes_and_aggregates(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(400.0, 2)
    for e in range(4):
        c.insert(K(0, e, "msb"), 50.0)
    assert {k.expert for k in c.shards[0].resident_keys()} == {0, 2}
    assert {k.expert for k in c.shards[1].resident_keys()} == {1, 3}
    assert len(c) == 4 and c.used == 200.0
    assert c.capacity == 400.0 and c.shards[0].capacity == 200.0
    msb, lsb = c.residency(1, 4)
    assert msb[0].all()
    return [msb, lsb, sorted(c.resident_keys()), c.usage()]


def sc_cache_stats_and_epochs(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(400.0, 2)
    c.begin_epoch("w0")
    c.access(K(0, 0, "msb"), 50.0)
    c.access(K(0, 1, "msb"), 50.0)
    c.access(K(0, 0, "msb"), 50.0)
    assert c.stats.accesses == 3 and c.stats.misses == 2
    c.begin_epoch("w1")
    c.access(K(0, 1, "msb"), 50.0)
    c.end_epoch()
    assert c.epoch_counts() == [("w0", 3, 2), ("w1", 1, 0)]
    return [c.epoch_counts(), c.per_shard_epoch_counts(), c.epochs,
            c.epoch_miss_rates(), c.per_shard_counts()]


def sc_cache_eviction_is_shard_local(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(200.0, 2)
    c.insert(K(0, 0, "msb"), 60.0)
    evicted = c.insert(K(1, 0, "msb"), 60.0)
    assert len(c.shards[0]) == 1
    assert c.can_fit(K(0, 1, "msb"), 80.0)
    return [evicted, [len(s) for s in c.shards], c.used]


def sc_cache_clone_isolated(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(400.0, 2)
    c.insert(K(0, 0, "msb"), 50.0)
    d = c.clone()
    d.insert(K(0, 1, "msb"), 50.0)
    assert len(c) == 1 and len(d) == 2
    return [len(c), len(d), sorted(d.resident_keys())]


def sc_cache_inflight_and_settle(m):
    K = m.SliceKey
    c = m.shard.ShardedSliceCache(400.0, 2)
    for e in range(3):
        c.insert(K(0, e, "lsb"), 30.0)
        c.mark_inflight(K(0, e, "lsb"), 1.0 + e)
    before = [c.ready_time(K(0, e, "lsb")) for e in range(3)]
    c.settle(2.0)
    after = [c.ready_time(K(0, e, "lsb")) for e in range(3)]
    c.evict(K(0, 1, "lsb"))
    gone = c.evict_where(lambda k: k.expert == 2)
    return [before, after, gone, sorted(c.resident_keys())]


# --------------------------------------------------------------------------
# sharded ledger
# --------------------------------------------------------------------------
def sc_ledger_single_shard_equals_plain(m):
    sysspec = m.SYSTEM_PROFILES["mobile_soc"]
    plain = m.energy.CostLedger(system=sysspec)
    sharded = m.energy.ShardedCostLedger(sysspec, 1)
    for led in (plain, sharded.shards[0]):
        led.miss_fill(1000.0)
        led.dram_read(1000.0)
        led.matmul(4, 64, 64, 8)
    a, b = plain.snapshot(), sharded.snapshot()
    assert a == b
    return b


def sc_ledger_makespan_max_energy_sum(m):
    sysspec = m.SYSTEM_PROFILES["mobile_soc"]
    led = m.energy.ShardedCostLedger(sysspec, 2)
    led.shards[0].miss_fill(4000.0)
    led.shards[1].miss_fill(1000.0)
    assert led.total_latency_s == pytest.approx(
        led.shards[0].total_latency_s)
    assert led.total_energy_j == pytest.approx(
        led.shards[0].total_energy_j + led.shards[1].total_energy_j)
    assert led.serial_latency_s > led.total_latency_s
    assert led.overlap_saved_s > 0
    return [led.snapshot(), led.per_shard_snapshots(),
            led.compute_frontier()]


def sc_ledger_ici_and_migration(m):
    sysspec = m.SYSTEM_PROFILES["mobile_soc"]
    led = m.energy.ShardedCostLedger(sysspec, 2)
    led.ici_transfer(1 << 20)
    snap = led.snapshot()
    assert snap["ici_bytes"] == 1 << 20
    assert snap["total_energy_j"] == pytest.approx(snap["ici_energy_j"])
    assert led.now == pytest.approx(
        (1 << 20) / sysspec.interconnect.bandwidth_bytes_per_s)
    span = led.ici_transfer_at(0.5, 4096.0)
    led.migrate(8192.0)
    mspan = led.migrate_at(1.0, 1024.0)
    return [snap, span, mspan, led.snapshot(), led.migration_bytes,
            led.n_migrations]


def sc_ledger_reset_and_clone(m):
    sysspec = m.SYSTEM_PROFILES["mobile_soc"]
    led = m.energy.ShardedCostLedger(sysspec, 3)
    for sid, s in enumerate(led.shards):
        s.fill_at(0.0, 1000.0 * (sid + 1))
        s.dram_read_at(0.1, 500.0)
        s.matmul_at(0.2, 2, 32, 32, 4)
    led.migrate(2048.0)
    twin = led.clone()
    led.reset()
    assert led.snapshot()["total_energy_j"] == 0.0
    assert led.now == 0.0
    plain = m.energy.CostLedger(system=sysspec)
    plain.ici_transfer(100.0)
    plain.reset()
    return [twin.snapshot(), led.snapshot(), plain.snapshot()]


# --------------------------------------------------------------------------
# replay equivalence and EP counterfactuals
# --------------------------------------------------------------------------
def _forced(async_io):
    def sc(m):
        tr = small_trace(m, engine_overrides={"async_io": async_io,
                                              "prefetch_top_m": 2})
        plain = m.sim.replay_trace(tr)
        eng = m.sim.ReplayEngine(tr.meta).force_sharded(1)
        eng.consume_all(tr.events)
        forced = eng.finish()
        assert forced.epoch_counts == plain.epoch_counts
        assert forced.miss_curve == plain.miss_curve
        assert forced.energy_curve == plain.energy_curve
        return report_view(forced)
    return sc


def sc_ep2_per_shard_accounting(m):
    tr = small_trace(m)
    r1 = m.sim.replay_trace(tr)
    r2 = m.sim.replay_trace(tr, ep_shards=2)
    for i, (label, acc, miss) in enumerate(r2.epoch_counts):
        s_acc = sum(ps[i][1] for ps in r2.per_shard_epoch_counts)
        s_miss = sum(ps[i][2] for ps in r2.per_shard_epoch_counts)
        assert (s_acc, s_miss) == (acc, miss)
    assert r2.ledger["ici_bytes"] > 0
    assert r2.total_latency_s < r1.total_latency_s
    assert r1.ledger["ici_bytes"] == 0.0
    assert r1.per_shard_epoch_counts is None
    return [report_view(r1), report_view(r2)]


def sc_ep_latency_improves_with_shards(m):
    tr = small_trace(m, decode_steps=16)
    lat = {ep: m.sim.replay_trace(tr, ep_shards=ep).total_latency_s
           for ep in (1, 2, 4)}
    assert lat[2] < lat[1] and lat[4] < lat[1]
    return lat


def sc_ep_sweepable_in_autotune(m):
    tr = small_trace(m)
    results = m.autotune.sweep(tr, [("ep1", {}), ("ep2", {"ep_shards": 2}),
                                    ("ep4", {"ep_shards": 4})])
    by_name = {r.name: r for r in results}
    assert by_name["ep2"].latency_s < by_name["ep1"].latency_s
    # steps_per_s is host wall time, not part of the result
    return [{k: v for k, v in r.row().items() if k != "steps_per_s"}
            for r in results]


def sc_old_meta_without_ep_shards(m):
    tr = small_trace(m)
    meta_engine = dict(tr.meta.engine)
    meta_engine.pop("ep_shards")
    old = m.sim.Trace(meta=dataclasses.replace(tr.meta, engine=meta_engine),
                      events=tr.events)
    a = m.sim.replay_trace(old)
    b = m.sim.replay_trace(old, ep_shards=2)
    assert b.ledger["ici_bytes"] > 0
    return [report_view(a), report_view(b)]


def _ep_async_prefetch(ep, kind):
    def sc(m):
        tr = small_trace(m, decode_steps=12, engine_overrides={
            "async_io": True, "prefetch_top_m": 2, "prefetch_kind": kind})
        return report_view(m.sim.replay_trace(tr, ep_shards=ep))
    return sc


def _prefill_only(m, active_cols):
    tr = small_trace(m, n_requests=1, prompt_len=4, decode_steps=0)
    ev = tr.events[0]
    active = np.zeros(ev.ids.shape, bool)
    active[..., :active_cols] = True
    tr.events[0] = m.trace.PrefillEvent(ids=ev.ids, gates=ev.gates,
                                        active=active, label=ev.label,
                                        inflight=ev.inflight)
    return tr


def sc_ep_prefill_active_mask(m):
    tr = _prefill_only(m, 1)
    out = []
    for ep in (1, 2):
        eng = m.sim.ReplayEngine(tr.meta, ep_shards=ep)
        eng.consume_all(tr.events)
        out.append([eng.cache.epoch_counts(), eng.cache.stats.snapshot(),
                    eng.tracker.counts, eng.ledger.snapshot()])
    return out


def sc_ep_shard_breakdown_view(m):
    tr = small_trace(m)
    eng = m.sim.ReplayEngine(tr.meta, ep_shards=4)
    eng.consume_all(tr.events)
    eng.finish()
    rows = eng.shard_breakdown()
    assert len(rows) == 4
    assert sum(r["accesses"] for r in rows) == sum(
        a for _, a, _ in eng.cache.epoch_counts())
    return rows


SCENARIOS = {
    "round_robin_placement": sc_round_robin_placement,
    "all_to_all_bytes": sc_all_to_all_bytes,
    "cache_routes_and_aggregates": sc_cache_routes_and_aggregates,
    "cache_stats_and_epochs": sc_cache_stats_and_epochs,
    "cache_eviction_is_shard_local": sc_cache_eviction_is_shard_local,
    "cache_clone_isolated": sc_cache_clone_isolated,
    "cache_inflight_and_settle": sc_cache_inflight_and_settle,
    "ledger_single_shard_equals_plain": sc_ledger_single_shard_equals_plain,
    "ledger_makespan_max_energy_sum": sc_ledger_makespan_max_energy_sum,
    "ledger_ici_and_migration": sc_ledger_ici_and_migration,
    "ledger_reset_and_clone": sc_ledger_reset_and_clone,
    "ep1_forced_sharded_sync": _forced(False),
    "ep1_forced_sharded_async": _forced(True),
    "ep2_per_shard_accounting": sc_ep2_per_shard_accounting,
    "ep_latency_improves_with_shards": sc_ep_latency_improves_with_shards,
    "ep_sweepable_in_autotune": sc_ep_sweepable_in_autotune,
    "old_meta_without_ep_shards": sc_old_meta_without_ep_shards,
    "ep2_async_request_prefetch": _ep_async_prefetch(2, "request"),
    "ep4_async_transition_prefetch": _ep_async_prefetch(4, "transition"),
    "ep_prefill_active_mask": sc_ep_prefill_active_mask,
    "ep_shard_breakdown_view": sc_ep_shard_breakdown_view,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_shard_scenario_matches_reference(name):
    run_both(SCENARIOS[name])


def test_sharded_ledger_tracer_hook_accepts_only_none():
    """The hook once accepted only ``None``; it now takes a tracer too,
    fans it out to every shard and the interconnect, and ``None`` still
    detaches."""
    led = PORT.energy.ShardedCostLedger(PORT.SYSTEM_PROFILES["mobile_soc"],
                                        2)
    led.attach_tracer(None)
    assert led.tracer is None
    trc = PORT.obs.TimelineTracer()
    led.attach_tracer(trc)
    assert all(s.tracer is trc for s in led.shards) and led.ici.tracer is trc
    led.attach_tracer(None)
    assert led.tracer is None and led.ici.tracer is None
