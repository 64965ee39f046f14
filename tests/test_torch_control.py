"""Port parity: the online SLO controller (``repro_torch.control``): signal
windows, config schema, decisions, admission, the tenant-partitioned
cache and controller replays.

Each scenario mirrors one of the reference's ``tests/test_control.py``
cases, runs on both packages through ``_torch_parity.run_both``
(controller actions, levels, budgets and miss counts exact, floats at
rtol 1e-6) and keeps the reference test's own assertions on the port's
result.  Model-free: no forward pass runs; the live scheduler wiring is
held in ``tests/test_torch_ep_engine.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import PORT, REF, assert_same, report_view, run_both


def _row(tokens=4, accesses=10, misses=0, critical=0, critical_low=0):
    return {"tokens": tokens, "accesses": accesses, "misses": misses,
            "critical": critical, "critical_low": critical_low}


def _ctl(m, slos, **over):
    base = dict(interval=4, window=16, cooldown=8, hysteresis=0.1,
                partition=True, admission=True)
    base.update(over)
    return m.control.SLOController(
        m.control.ControllerConfig(slos=slos, **base), cache_bytes=1000.0)


def _run(ctl, rows, n):
    out = {}
    for _ in range(n):
        out = ctl.observe_step({t: dict(r) for t, r in rows.items()})
    return out


def _view(ctl):
    return [ctl.summary(), ctl.actions, ctl.budgets, ctl.levels]


# --------------------------------------------------------------------------
# signal windows
# --------------------------------------------------------------------------
def sc_empty_windows(m):
    w = m.signals.TenantWindow(8)
    assert w.miss_rate() is None and w.lowbit_frac() is None
    assert m.signals.SlidingWindow(8).percentile(95) is None
    return True


def sc_ratios_traffic_weighted(m):
    w = m.signals.TenantWindow(8)
    w.push(_row(accesses=10, misses=5))
    w.push(_row(accesses=90, misses=0))
    assert w.miss_rate() == pytest.approx(0.05)
    return w.miss_rate()


def sc_window_bounded(m):
    w = m.signals.TenantWindow(4)
    for _ in range(10):
        w.push(_row(accesses=1, misses=1))
    for _ in range(4):
        w.push(_row(accesses=1, misses=0))
    assert len(w) == 4 and w.miss_rate() == 0.0
    return [len(w), w.miss_rate()]


def sc_lowbit_frac(m):
    w = m.signals.TenantWindow(8)
    w.push(_row(critical=8, critical_low=2))
    assert w.lowbit_frac() == pytest.approx(0.25)
    return w.lowbit_frac()


def sc_tenant_signals(m):
    s = m.signals.TenantSignals(8)
    for x in (0.1, 0.3, 0.2, 0.5):
        s.on_first_token(x)
        s.on_submit()
    return [s.ttft_s.percentile(50), s.ttft_s.percentile(95)]


# --------------------------------------------------------------------------
# config schema
# --------------------------------------------------------------------------
def sc_slo_validation(m):
    for kw in (dict(bit_floor="medium"), dict(lowbit_frac=1.5)):
        with pytest.raises(ValueError):
            m.control.TenantSLO(**kw)
    with pytest.raises(ValueError):
        m.control.ControllerConfig(slos={})
    with pytest.raises(ValueError):
        m.control.ControllerConfig(slos={"a": m.control.TenantSLO()},
                                   interval=0)
    return True


def sc_json_roundtrip(m):
    cfg = m.control.ControllerConfig(
        slos={"p": m.control.TenantSLO(miss_rate=0.1, lowbit_frac=0.05,
                                       bit_floor="high"),
              "b": m.control.TenantSLO(miss_rate=0.3, ttft_s=0.05)},
        interval=8, cooldown=16, hysteresis=0.2)
    d = cfg.to_dict()
    back = m.control.ControllerConfig.from_dict(json.loads(json.dumps(d)))
    assert back == cfg
    plain = m.control.ControllerConfig(slos={"a": {"miss_rate": 0.2}})
    assert plain.slos["a"] == m.control.TenantSLO(miss_rate=0.2)
    return [d, plain.to_dict()]


def test_controller_config_dicts_cross_packages():
    """A config dict written by either package builds the other's."""
    d = PORT.control.ControllerConfig(
        slos={"p": {"miss_rate": 0.1, "bit_floor": "high"},
              "b": {"miss_rate": 0.3}}, interval=2, partition=True).to_dict()
    j = REF.control.ControllerConfig.from_dict(d)
    t = PORT.control.ControllerConfig.from_dict(j.to_dict())
    assert t.to_dict() == d


# --------------------------------------------------------------------------
# decision logic
# --------------------------------------------------------------------------
def sc_demotes_on_miss(m):
    ctl = _ctl(m, {"a": m.control.TenantSLO(miss_rate=0.1)})
    _run(ctl, {"a": _row(accesses=10, misses=5)}, 4)
    assert ctl.levels["a"] == 1
    return _view(ctl)


def sc_hysteresis_dead_band(m):
    ctl = _ctl(m, {"a": m.control.TenantSLO(miss_rate=0.1)})
    _run(ctl, {"a": _row(accesses=1000, misses=105)}, 8)
    assert ctl.levels["a"] == 0 and not ctl.actions
    return _view(ctl)


def sc_bit_floor_high_repartitions(m):
    S = m.control.TenantSLO
    ctl = _ctl(m, {"pin": S(miss_rate=0.1, bit_floor="high"),
                   "quiet": S()})
    before = dict(ctl.budgets)
    out = _run(ctl, {"pin": _row(accesses=10, misses=5),
                     "quiet": _row(accesses=10, misses=0)}, 4)
    assert ctl.budgets["pin"] > before["pin"]
    assert out["budgets"] == ctl.budgets
    return [out, _view(ctl)]


def sc_no_quiet_donor(m):
    S = m.control.TenantSLO
    ctl = _ctl(m, {"a": S(miss_rate=0.1, bit_floor="high"),
                   "b": S(miss_rate=0.1, bit_floor="high")})
    before = dict(ctl.budgets)
    _run(ctl, {"a": _row(accesses=10, misses=5),
               "b": _row(accesses=10, misses=5)}, 4)
    assert ctl.budgets == before and not ctl.actions
    return _view(ctl)


def sc_cooldown(m):
    ctl = _ctl(m, {"a": m.control.TenantSLO(miss_rate=0.1,
                                            lowbit_frac=0.5)})
    rows = {"a": _row(accesses=10, misses=5, critical=10, critical_low=10)}
    levels = []
    for _ in range(3):
        _run(ctl, rows, 4)
        levels.append(ctl.levels["a"])
    assert levels == [1, 1, 0]
    return [levels, _view(ctl)]


def sc_accuracy_guard_priority(m):
    ctl = _ctl(m, {"a": m.control.TenantSLO(miss_rate=0.1,
                                            lowbit_frac=0.2)},
               cooldown=4, partition=False)
    rows = {"a": _row(accesses=10, misses=5, critical=10, critical_low=9)}
    _run(ctl, rows, 8)
    assert ctl.levels["a"] == 0 and ctl.actions[-1]["kind"] == "promote"
    return _view(ctl)


def sc_plan_bits(m):
    S = m.control.TenantSLO
    ctl = _ctl(m, {"a": S(), "b": S()})
    ctl.levels["b"] = 1
    lv = ctl.plan_bits(["a", "b", None, "unknown"], 4)
    assert lv.tolist() == [0, 1, 0, 0]
    return [lv, ctl.plan_bits(None, 3), ctl.low_bit_fraction()]


def sc_long_mixed_run(m):
    """A longer seeded counter stream across three tenants: every
    decision of the loop, in order."""
    S = m.control.TenantSLO
    ctl = _ctl(m, {"p": S(miss_rate=0.05, lowbit_frac=0.3),
                   "b": S(miss_rate=0.2),
                   "pin": S(miss_rate=0.1, bit_floor="high")},
               interval=2, cooldown=4)
    rng = np.random.default_rng(11)
    for _ in range(60):
        rows = {}
        for t in ("p", "b", "pin"):
            acc = int(rng.integers(5, 40))
            crit = int(rng.integers(0, 10))
            rows[t] = _row(accesses=acc, misses=int(rng.integers(0, acc)),
                           critical=crit,
                           critical_low=int(rng.integers(0, crit + 1)))
        ctl.observe_step(rows)
    return _view(ctl)


# --------------------------------------------------------------------------
# admission actuator
# --------------------------------------------------------------------------
def _req(t):
    return dataclasses.make_dataclass("R", ["tenant"])(t)


def sc_thinning(m):
    ctl = _ctl(m, {"bg": m.control.TenantSLO()})
    full = [ctl.admit_request(_req("bg")) for _ in range(4)]
    ctl.admit_fracs["bg"] = 0.5
    half = [ctl.admit_request(_req("bg")) for _ in range(8)]
    assert all(full)
    return [full, half]


def sc_ttft_throttles_background(m):
    S = m.control.TenantSLO
    ctl = _ctl(m, {"lat": S(ttft_s=0.01), "bg": S()}, interval=2,
               admit_step=0.25)
    for _ in range(8):
        ctl.signals["lat"].on_first_token(0.1)
    for _ in range(2):
        ctl.on_step(None)
    first = dict(ctl.admit_fracs)
    assert first == {"bg": 0.75, "lat": 1.0}
    for _ in range(20):
        ctl.on_step(None)
    assert ctl.admit_fracs["bg"] == ctl.cfg.min_admit_frac
    return [first, _view(ctl)]


def sc_admission_recovers(m):
    S = m.control.TenantSLO
    ctl = _ctl(m, {"lat": S(ttft_s=0.01), "bg": S()}, interval=2)
    ctl.signals["lat"].on_first_token(0.1)
    for _ in range(2):
        ctl.on_step(None)
    low = ctl.admit_fracs["bg"]
    ctl.signals["lat"].ttft_s.clear()
    for _ in range(20):
        ctl.on_step(None)
    assert low < 1.0 and ctl.admit_fracs["bg"] == 1.0
    return [low, _view(ctl)]


# --------------------------------------------------------------------------
# tenant-partitioned cache
# --------------------------------------------------------------------------
K = 100.0


def _pcache(m, **over):
    base = dict(capacity_bytes=1000.0, tenants=["a", "b"], shared_frac=0.2)
    base.update(over)
    return m.control.TenantPartitionedCache(**base)


def _keys(m, n, layer=0):
    return [m.SliceKey(layer, e, "msb") for e in range(n)]


def sc_shared_lookup(m):
    c = _pcache(m)
    key = m.SliceKey(0, 0, "msb")
    c.set_active_tenant("a")
    miss = c.access(key, K)
    c.set_active_tenant("b")
    hit = c.access(key, K)
    assert not miss and hit
    return [c.stats.snapshot(), c.budgets(), c.usage()]


def sc_isolated_eviction(m):
    c = _pcache(m)
    c.set_active_tenant("a")
    for k in _keys(m, 4):
        c.access(k, K)
    c.set_active_tenant("b")
    for k in _keys(m, 8, layer=1):
        c.access(k, K)
    assert all(k in c for k in _keys(m, 4))
    return [sorted(c.segments["a"].resident_keys()),
            sorted(c.segments["b"].resident_keys()), c.stats.snapshot()]


def sc_unattributed_to_shared(m):
    c = _pcache(m)
    c.set_active_tenant(None)
    c.access(m.SliceKey(0, 0, "msb"), K)
    assert m.SliceKey(0, 0, "msb") in c.segments["shared"]
    return [c.fill_capacity(), sorted(c.resident_keys())]


def sc_set_budgets(m):
    c = _pcache(m)
    c.set_active_tenant("a")
    for k in _keys(m, 4):
        c.access(k, K)
    evicted = c.set_budgets({"a": 150.0})
    assert evicted == _keys(m, 4)[:3]
    with pytest.raises(KeyError):
        c.set_budgets({"nope": 100.0})
    with pytest.raises(ValueError):
        c.set_budgets({"a": -1.0})
    return [evicted, c.budgets(), c.residency(1, 4)]


def sc_partition_names(m):
    for tenants in (["shared"], []):
        with pytest.raises(ValueError):
            _pcache(m, tenants=tenants)
    c = _pcache(m)
    c.begin_epoch("x")
    c.set_active_tenant("b")
    c.access(m.SliceKey(0, 1, "lsb"), K)
    c.end_epoch()
    d = c.clone()
    d.access(m.SliceKey(0, 2, "lsb"), K)
    return [c.epoch_counts(), len(c), len(d)]


# --------------------------------------------------------------------------
# controller replays (model-free)
# --------------------------------------------------------------------------
def _soak(m, seed=0):
    spec = m.sim.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
    return m.sim.tenant_phase_trace(
        spec, tenants=[{"premium": 1.0, "batch": 3.0}, {"premium": 1.0}],
        phases=2, requests_per_phase=2, prompt_len=8, decode_steps=8,
        seed=seed)


def _tight(m, **over):
    base = dict(interval=4, window=16, cooldown=8, partition=False)
    base.update(over)
    S = m.control.TenantSLO
    return m.control.ControllerConfig(
        slos={"premium": S(miss_rate=1e-6), "batch": S(miss_rate=1e-6)},
        **base)


def sc_replay_tight_slo(m):
    r = m.sim.replay_trace(_soak(m), controller=_tight(m))
    assert r.controller_summary["n_actions"] >= 1
    assert set(r.controller_summary["levels"].values()) == {1}
    assert "controller" in r.summary()
    return report_view(r)


def sc_replay_demotion_saves_energy(m):
    base = m.sim.replay_trace(_soak(m))
    ctl = m.sim.replay_trace(_soak(m), controller=_tight(m, interval=1))
    assert base.controller_summary is None
    assert ctl.total_energy_j < base.total_energy_j
    return [report_view(base), report_view(ctl)]


def _replay_partitioned(async_io, prefetch):
    def sc(m):
        S = m.control.TenantSLO
        cfg = m.control.ControllerConfig(
            slos={"premium": S(miss_rate=0.05, bit_floor="high"),
                  "batch": S(miss_rate=0.05)},
            interval=2, window=8, cooldown=4, partition=True)
        over = {"async_io": async_io}
        if prefetch:
            over.update(prefetch_top_m=2, prefetch_kind=prefetch)
        r = m.sim.replay_trace(_soak(m, seed=3), controller=cfg, **over)
        return report_view(r)
    return sc


def sc_controller_meta_roundtrips(m):
    """A trace carrying controller meta replays under it (the dict form
    that a recorded trace stores)."""
    tr = _soak(m)
    meta = dataclasses.replace(tr.meta, engine={
        **tr.meta.engine, "controller": _tight(m).to_dict()})
    r = m.sim.replay_trace(m.sim.Trace(meta=meta, events=tr.events))
    return report_view(r)


SCENARIOS = {
    "empty_windows": sc_empty_windows,
    "ratios_traffic_weighted": sc_ratios_traffic_weighted,
    "window_bounded": sc_window_bounded,
    "lowbit_frac": sc_lowbit_frac,
    "tenant_signals": sc_tenant_signals,
    "slo_validation": sc_slo_validation,
    "json_roundtrip": sc_json_roundtrip,
    "demotes_on_miss": sc_demotes_on_miss,
    "hysteresis_dead_band": sc_hysteresis_dead_band,
    "bit_floor_high_repartitions": sc_bit_floor_high_repartitions,
    "no_quiet_donor": sc_no_quiet_donor,
    "cooldown": sc_cooldown,
    "accuracy_guard_priority": sc_accuracy_guard_priority,
    "plan_bits": sc_plan_bits,
    "long_mixed_run": sc_long_mixed_run,
    "thinning": sc_thinning,
    "ttft_throttles_background": sc_ttft_throttles_background,
    "admission_recovers": sc_admission_recovers,
    "shared_lookup": sc_shared_lookup,
    "isolated_eviction": sc_isolated_eviction,
    "unattributed_to_shared": sc_unattributed_to_shared,
    "set_budgets": sc_set_budgets,
    "partition_names": sc_partition_names,
    "replay_tight_slo": sc_replay_tight_slo,
    "replay_demotion_saves_energy": sc_replay_demotion_saves_energy,
    "replay_partitioned_sync": _replay_partitioned(False, None),
    "replay_partitioned_async": _replay_partitioned(True, None),
    "replay_partitioned_request_prefetch":
        _replay_partitioned(True, "request"),
    "replay_partitioned_transition_prefetch":
        _replay_partitioned(False, "transition"),
    "controller_meta_roundtrips": sc_controller_meta_roundtrips,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_scenario_matches_reference(name):
    run_both(SCENARIOS[name])


def test_controller_replay_is_deterministic():
    a = PORT.sim.replay_trace(_soak(PORT), controller=_tight(PORT))
    b = PORT.sim.replay_trace(_soak(PORT), controller=_tight(PORT))
    assert_same(report_view(a), report_view(b))
    rows = PORT.sim.replay_trace(_soak(PORT)).per_tenant_rows
    assert rows and all(set(r) <= {"premium", "batch"} for r in rows)


def test_partition_with_ep_shards_raises():
    from repro_torch.core.engine import EngineConfig

    cfg = EngineConfig(controller=_tight(PORT, partition=True), ep_shards=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        cfg.cache()
