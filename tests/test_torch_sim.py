"""Port parity: trace I/O, synthetic traces, replay and autotune.

The port's ``repro_torch.sim`` against the reference's ``repro.sim`` on the
same inputs: traces written by either package load in the other and are
equal by ``traces_equal``; every synthetic generator gives the
reference's trace from the same spec and seed; replay reports agree over
a grid of overrides (epoch counts, decode totals and prefetch counters
exactly, curves and the ledger at rtol 1e-6, the tolerance of
``tests/test_golden_trace.py``); clones fork independently; autotune
gives the reference's rows.  Model-free: no forward pass runs.
"""

import json
import pathlib

import numpy as np
import pytest

from repro import sim as J
from repro.serving import workloads as JW
from repro.sim import autotune as JA
from repro_torch import sim as T
from repro_torch.core.engine import EngineConfig
from repro_torch.serving import workloads as TW
from repro_torch.sim import autotune as TA

DATA = pathlib.Path(__file__).resolve().parent / "data"

JSPEC = J.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
TSPEC = T.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
KW = dict(n_requests=3, prompt_len=6, decode_steps=10, seed=4)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=1e-6,
                               atol=0.0, err_msg=what)


def assert_reports_equal(j, t):
    """Reference report ``j`` against port report ``t``."""
    assert t.epoch_counts == [tuple(r) for r in j.epoch_counts]
    assert (t.n_prefills, t.n_decode_steps) == (j.n_prefills,
                                                 j.n_decode_steps)
    assert (t.decode_accesses, t.decode_misses) == (j.decode_accesses,
                                                    j.decode_misses)
    assert t.prefetch == j.prefetch
    for name in ("miss_curve", "energy_curve", "alpha_curve"):
        _close(getattr(j, name), getattr(t, name), name)
    assert set(t.ledger) == set(j.ledger)
    for k in j.ledger:
        _close(j.ledger[k], t.ledger[k], f"ledger[{k}]")


# --------------------------------------------------------------------------
# trace files: each package reads the other's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ext", ["npz", "jsonl"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trace_files_cross_read(tmp_path, ext, writer):
    jt = J.zipf_trace(JSPEC, **KW)
    tt = T.zipf_trace(TSPEC, **KW)
    src = jt if writer == "reference" else tt
    path = src.save(str(tmp_path / f"t.{ext}"))
    if writer == "reference":
        got = T.Trace.load(path)
        assert T.traces_equal(got, tt)
    else:
        got = J.Trace.load(path)
        assert J.traces_equal(got, jt)
    # the ids keep the reference's on-disk dtype
    assert got.events[0].ids.dtype == np.int32


def test_trace_file_with_active_and_tenants_cross_reads(tmp_path):
    """The optional ``active`` prefill array and the decode tenants."""
    tt = T.zipf_trace(TSPEC, **KW)
    ev = tt.events[0]
    ev.active = np.ones(ev.ids.shape, bool)
    ev.active[..., -1] = False
    tt.events[1].slot_tenants = ["chat"]
    got = J.Trace.load(tt.save(str(tmp_path / "t.npz")))
    np.testing.assert_array_equal(got.events[0].active, ev.active)
    assert got.events[1].slot_tenants == ["chat"]
    back = T.Trace.load(got.save(str(tmp_path / "u.jsonl")))
    assert T.traces_equal(back, tt)


# --------------------------------------------------------------------------
# synthetic generators
# --------------------------------------------------------------------------
def _tenant_workload(mod):
    return mod.WorkloadConfig(
        kind="poisson", n_requests=5, seed=3, tenants=(
            mod.TenantSpec(name="chat", weight=3.0,
                           output_len=mod.LengthDist("fixed", 4)),
            mod.TenantSpec(name="sum", weight=1.0,
                           prompt_len=mod.LengthDist("uniform", low=4,
                                                     high=9),
                           output_len=mod.LengthDist("lognormal", value=3,
                                                     max_len=6))))


GENERATORS = {
    "zipf": lambda m, spec: m.zipf_trace(spec, **KW),
    "phase_shift": lambda m, spec: m.phase_shift_trace(
        spec, phases=2, requests_per_phase=2, prompt_len=5,
        decode_steps=6, seed=2),
    "tenant_mix": lambda m, spec: m.tenant_mix_trace(
        spec, workload=_tenant_workload(
            JW if m is J else TW), vocab_size=512),
    "tenant_phase": lambda m, spec: m.tenant_phase_trace(
        spec, tenants=[{"a": 1.0, "b": 2.0}, {"a": 3.0}], phases=2,
        requests_per_phase=2, prompt_len=5, decode_steps=6, seed=1),
    "transition": lambda m, spec: m.transition_trace(
        spec, n_requests=2, prompt_len=6, decode_steps=8, seed=9,
        engine_overrides={"prefetch_top_m": 3}),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_synthetic_generator_matches_reference(tmp_path, gen):
    jt = GENERATORS[gen](J, JSPEC)
    tt = GENERATORS[gen](T, TSPEC)
    # compare in one package: the port's trace read back by the reference
    got = J.Trace.load(tt.save(str(tmp_path / "t.npz")))
    assert J.traces_equal(got, jt)
    assert TSPEC.store_bytes() == JSPEC.store_bytes()


def test_zipf_trace_reproduces_golden_file():
    golden = T.Trace.load(str(DATA / "golden_trace.npz"))
    kw = json.loads((DATA / "golden_expected.json").read_text())["trace_kw"]
    spec = T.SyntheticSpec(n_moe_layers=3, n_experts=12, top_k=2)
    made = T.zipf_trace(spec, **kw)
    # The file predates the placement knobs; the reference's generator
    # adds them to the header just as the port's does.
    engine = {k: v for k, v in made.meta.engine.items()
              if k not in ("placement", "placement_period", "replicate_k")}
    assert engine == golden.meta.engine
    assert T.traces_equal(T.Trace(meta=golden.meta, events=made.events),
                          golden)


@pytest.mark.parametrize("name", ["steady", "bursty", "closed_loop",
                                  "multi_tenant"])
def test_workload_scenarios_match_reference(name):
    jr = JW.generate(JW.scenario(name, n_requests=12, seed=5), 300)
    tr = TW.generate(TW.scenario(name, n_requests=12, seed=5), 300)
    assert [(r.request_id, r.arrival_time, r.tenant, r.max_new_tokens)
            for r in tr] == [(r.request_id, r.arrival_time, r.tenant,
                              r.max_new_tokens) for r in jr]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.prompt, a.prompt)


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traces():
    return {"zipf": (J.zipf_trace(JSPEC, **KW), T.zipf_trace(TSPEC, **KW)),
            "transition": (GENERATORS["transition"](J, JSPEC),
                           GENERATORS["transition"](T, TSPEC)),
            "tenant_mix": (GENERATORS["tenant_mix"](J, JSPEC),
                           GENERATORS["tenant_mix"](T, TSPEC))}


PF = dict(prefetch_top_m=3, prefetch_lookahead=2, prefetch_min_score=0.02)
OVERRIDES = {
    "recorded": ("zipf", {}),
    "small_cache": ("zipf", dict(cache_bytes=6e4)),
    "warmup_empty": ("zipf", dict(warmup="empty")),
    "warmup_last_layer": ("zipf", dict(warmup="last_layer")),
    "highbit": ("zipf", dict(slice_mode="highbit")),
    "lowbit": ("zipf", dict(slice_mode="lowbit")),
    "mat63": ("zipf", dict(high_bits=6, low_bits=3)),
    "fused": ("zipf", dict(fused_slices=True, slice_mode="highbit")),
    "async": ("zipf", dict(async_io=True)),
    "request_sync": ("zipf", dict(PF, prefetch_kind="request",
                                  warmup="empty", cache_bytes=1.5e5)),
    "request_async": ("zipf", dict(PF, prefetch_kind="request",
                                   async_io=True, warmup="empty",
                                   cache_bytes=1.5e5)),
    "transition_sync": ("transition", dict(prefetch_kind="transition",
                                           warmup="empty",
                                           cache_bytes=1.5e5)),
    "transition_async": ("transition", dict(prefetch_kind="transition",
                                            async_io=True, warmup="empty",
                                            cache_bytes=1.5e5)),
    "tenants_async_request": ("tenant_mix", dict(
        PF, prefetch_kind="request", async_io=True, miss_rate_target=0.1)),
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_replay_report_matches_reference(traces, case):
    which, over = OVERRIDES[case]
    jt, tt = traces[which]
    j = J.replay_trace(jt, **over)
    t = T.replay_trace(tt, **over)
    assert_reports_equal(j, t)
    # The port's tenant rows carry the counters of its charge path (the
    # reference adds its SLO controller's critical-selection counts).
    assert t.per_tenant_rows == (None if j.per_tenant_rows is None else [
        {ten: {k: row[k] for k in ("tokens", "accesses", "misses")}
         for ten, row in step.items()} for step in j.per_tenant_rows])
    if t.prefetch is not None:
        p = t.prefetch
        assert p["issued"] > 0, p
        assert p["issued"] == p["useful"] + p["late"] + p["wasted"]


def test_async_replay_keeps_energy_and_lowers_latency(traces):
    """The reference's timeline invariant on the port: the pipelined
    replay of one trace spends the serialized replay's energy and bytes
    and finishes no later."""
    _, tt = traces["zipf"]
    sync = T.replay_trace(tt)
    asyn = T.replay_trace(tt, async_io=True)
    for k in ("total_energy_j", "flash_bytes", "dram_bytes", "compute_ops"):
        np.testing.assert_allclose(asyn.ledger[k], sync.ledger[k],
                                   rtol=1e-12, err_msg=k)
    assert asyn.total_latency_s < sync.total_latency_s
    assert sync.ledger["overlap_saved_s"] == pytest.approx(0.0, abs=1e-15)
    assert asyn.ledger["overlap_saved_s"] > 0.0
    assert asyn.epoch_counts == sync.epoch_counts


@pytest.mark.parametrize("over", [{}, dict(PF, async_io=True,
                                            warmup="empty",
                                            cache_bytes=1.5e5)],
                         ids=["recorded", "request_async"])
def test_clone_forks_are_isolated(traces, over):
    _, tr = traces["zipf"]
    cut = len(tr.events) // 2
    eng = T.ReplayEngine(tr.meta, **over)
    eng.consume_all(tr.events[:cut])
    fork = eng.clone()
    # both futures replay the same remainder -> identical reports...
    rep_a = eng.consume_all(tr.events[cut:]).finish()
    rep_b = fork.consume_all(tr.events[cut:]).finish()
    assert rep_a.ledger == rep_b.ledger
    assert rep_a.miss_curve == rep_b.miss_curve
    assert rep_a.epoch_counts == rep_b.epoch_counts
    assert rep_a.prefetch == rep_b.prefetch
    # ...and match an unforked straight-through replay exactly
    rep_c = T.replay_trace(tr, **over)
    assert rep_a.ledger == rep_c.ledger
    assert rep_a.miss_curve == rep_c.miss_curve
    assert rep_a.prefetch == rep_c.prefetch
    # diverging one fork must not disturb the other (state isolation)
    fork2 = T.ReplayEngine(tr.meta, **over)
    fork2.consume_all(tr.events[:cut])
    fork3 = fork2.clone()
    before = fork2.ledger.snapshot()
    pending = {l: dict(m) for l, m in fork2._pf_pending.items()}
    fork3.consume_all(tr.events[cut:]).finish()
    assert fork2.ledger.snapshot() == before
    assert fork2._pf_pending == pending


def test_replay_engine_rejects_live_api():
    eng = T.ReplayEngine(T.zipf_trace(TSPEC, **KW).meta)
    with pytest.raises(TypeError):
        eng.run_prefill(None)
    with pytest.raises(TypeError):
        eng.decode_batch(None, None)
    with pytest.raises(KeyError):
        T.engine_config_from_meta(eng.meta, cache_byte=1e6)


@pytest.mark.parametrize("over", [
    dict(ep_shards=2), dict(controller={"slos": {}}),
    dict(placement="hotness"), dict(placement_period=16),
    dict(replicate_k=1)], ids=["ep_shards", "controller", "placement",
                               "placement_period", "replicate_k"])
def test_replay_of_unported_knobs_names_its_queue_item(over):
    meta = T.zipf_trace(TSPEC, **KW).meta
    with pytest.raises(NotImplementedError, match="EP, placement, control"):
        T.ReplayEngine(meta, **over)
    with pytest.raises(NotImplementedError, match="EP, placement, control"):
        T.replay_trace(T.zipf_trace(TSPEC, **KW), **over)


def test_force_sharded_names_its_queue_item():
    eng = T.ReplayEngine(T.zipf_trace(TSPEC, **KW).meta)
    with pytest.raises(NotImplementedError, match="EP, placement, control"):
        eng.force_sharded(1)


def test_replay_engine_touches_no_device():
    """The charge path runs without a device or a model: the replay
    engine carries neither attribute."""
    eng = T.ReplayEngine(T.zipf_trace(TSPEC, **KW).meta)
    assert not hasattr(eng, "device") and not hasattr(eng, "qparams")
    assert isinstance(eng.ecfg, EngineConfig)


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------
def _policies(meta):
    base = meta.engine["cache_bytes"]
    return [("small", {"cache_bytes": base * 0.5}), ("default", {}),
            ("big", {"cache_bytes": base * 4}),
            ("big-empty", {"cache_bytes": base * 4, "warmup": "empty"}),
            ("async-request", dict(PF, async_io=True))]


@pytest.mark.parametrize("halving", [False, True], ids=["full", "halving"])
def test_sweep_rows_match_reference(traces, halving):
    jt, tt = traces["zipf"]
    kw = dict(successive_halving=halving, min_frac=0.25, miss_slo=0.6)
    jr = JA.sweep(jt, _policies(jt.meta), **kw)
    tr = TA.sweep(tt, _policies(tt.meta), **kw)
    assert [(r.name, r.partial, r.events_consumed) for r in tr] == \
        [(r.name, r.partial, r.events_consumed) for r in jr]
    for a, b in zip(jr, tr):
        assert b.overrides == a.overrides
        assert b.miss_rate == a.miss_rate
        _close(a.energy_j, b.energy_j, a.name)
        _close(a.latency_s, b.latency_s, a.name)
    names = lambda rs: [r.name for r in rs]   # noqa: E731
    assert names(TA.pareto_frontier(tr)) == names(JA.pareto_frontier(jr))
    for slo in (0.3, 0.45, 0.6):
        jb, tb = JA.best_under_slo(jr, slo), TA.best_under_slo(tr, slo)
        assert (tb and tb.name) == (jb and jb.name)
    assert TA.grid(cache_bytes=[1e6, 2e6], warmup=["pcw", "empty"]) == \
        JA.grid(cache_bytes=[1e6, 2e6], warmup=["pcw", "empty"])
    text = TA.format_results(tr, miss_slo=0.45)
    assert text.splitlines()[0] == "--- autotune sweep ---"
    assert len(text.splitlines()) == len(tr) + 3
