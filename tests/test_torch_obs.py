"""Port parity: observability (``repro_torch.obs``): the timeline tracer,
the Chrome-trace export, the metrics registry and sampler, the trace
report, and the telemetry schema and percentile regressions.

The first part holds every model-free test of ``tests/test_obs.py`` on the
port (the live test's counterpart is in ``test_torch_obs_live.py``).  The
second runs each scenario on both packages through
``_torch_parity.run_both``: the synthetic traced replays give equal event
streams (kinds, channels, shards, attribution and steps exact; times,
bytes and ops at rtol 1e-6), equal ``chrome_trace`` dicts, and reports
that agree across the packages' exported files; the same ``StepRecord``
stream gives equal metrics snapshots and Prometheus text.  Attaching a
tracer changes no ledger figure or miss count.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import PORT, REF, assert_same, report_view, run_both
from repro_torch.hw.energy import ShardedCostLedger
from repro_torch.obs import (MetricsRegistry, MetricsSampler, TimelineTracer,
                             chrome_trace, events_equal, export_chrome_trace,
                             first_divergence, format_trace_report,
                             load_trace, trace_report)
from repro_torch.obs.timeline import (CHANNEL_TIDS, INTERCONNECT_PID,
                                      REQUESTS_PID)
from repro_torch.serving.telemetry import (FleetTelemetry, RequestRecord,
                                           StepRecord, format_summary,
                                           percentile)
from repro_torch.sim import SyntheticSpec, zipf_trace
from repro_torch.sim.replay import ReplayEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CH_ATTR = {"flash": "flash_ch", "flash_bg": "flash_bg_ch",
           "dram": "dram_ch", "compute": "compute_ch", "ici": "ici_ch"}


def _traced_replay(ns=PORT, trace=True, **overrides):
    """Synthetic trace -> (optionally traced) replay through ``ns``'s
    package.  Returns (engine, tracer)."""
    tr = ns.sim.zipf_trace(ns.sim.SyntheticSpec(), n_requests=3,
                           prompt_len=8, decode_steps=6, zipf_a=1.2,
                           seed=0, engine_overrides=overrides)
    eng = ns.sim.ReplayEngine(tr.meta)
    if trace:
        eng.attach_tracer(ns.obs.TimelineTracer())
    eng.consume_all(tr.events)
    eng.finish()
    return eng, eng.tracer


def _shard_ledgers(ledger):
    if isinstance(ledger, ShardedCostLedger):
        out = {sid: led for sid, led in enumerate(ledger.shards)}
        out[-1] = ledger.ici
        return out
    return {0: ledger}


# ==========================================================================
# Trace capture: conservation + makespan gates (port)
# ==========================================================================
CONFIGS = [
    {},                                              # serialized, ep=1
    {"async_io": True, "prefetch_top_m": 2},         # async + prefetch
    {"async_io": True, "ep_shards": 2},              # expert parallel
    {"async_io": True, "ep_shards": 2, "placement": "hotness",
     "placement_period": 4},                         # with migration
]
IDS = ["sync", "async_prefetch", "async_ep2", "async_ep2_hotness"]


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_event_conservation(over):
    """Every ledger charge appears exactly once in the capture."""
    eng, trc = _traced_replay(**over)
    snap = eng.ledger.snapshot()
    kinds = {}
    for e in trc.events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    assert kinds.get("fill", 0) + kinds.get("prefetch_fill", 0) \
        == snap["n_flash_transfers"]
    assert kinds.get("dram_read", 0) == snap["n_dram_transfers"]
    assert kinds.get("matmul", 0) == snap["n_matmuls"]
    assert kinds.get("a2a", 0) + kinds.get("migrate", 0) \
        == snap["n_ici_transfers"]
    fill_bytes = sum(e.nbytes for e in trc.events
                     if e.kind in ("fill", "prefetch_fill"))
    assert fill_bytes == pytest.approx(snap["flash_bytes"], rel=1e-9)
    assert sum(e.nbytes for e in trc.events if e.kind == "dram_read") \
        == pytest.approx(snap["dram_bytes"], rel=1e-9)
    assert sum(e.ops for e in trc.events if e.kind == "matmul") \
        == pytest.approx(snap["compute_ops"], rel=1e-9)


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_makespan_matches_ledger(over):
    """Tracer makespan == ledger latency; every traced channel's last
    event end == that channel's busy_until clock (rtol 1e-6)."""
    eng, trc = _traced_replay(**over)
    assert trc.makespan() == pytest.approx(
        eng.ledger.total_latency_s, rel=1e-6)
    leds = _shard_ledgers(eng.ledger)
    for (shard, channel), end in trc.channel_makespans().items():
        ch = getattr(leds[shard], CH_ATTR[channel])
        assert end == pytest.approx(ch.busy_until, rel=1e-6), \
            (shard, channel)


def test_ep2_shard_tracks_and_a2a():
    _, trc = _traced_replay(async_io=True, ep_shards=2)
    shards = {e.shard for e in trc.events}
    assert shards == {-1, 0, 1}
    a2a = [e for e in trc.events if e.kind == "a2a"]
    assert a2a and all(e.shard == -1 and e.channel == "ici" for e in a2a)


def test_migration_events_distinct_from_a2a():
    eng, trc = _traced_replay(async_io=True, ep_shards=2,
                              placement="hotness", placement_period=4)
    mig = [e for e in trc.events if e.kind == "migrate"]
    assert len(mig) == eng.ledger.snapshot()["n_migrations"]
    assert mig, "no migration within the run"
    assert all(e.layer >= 0 and e.expert >= 0 and e.slice_kind
               for e in mig)


def test_prefetch_lane_distinct():
    _, trc = _traced_replay(async_io=True, prefetch_top_m=2)
    pf = [e for e in trc.events if e.kind == "prefetch_fill"]
    demand = [e for e in trc.events if e.kind == "fill"]
    assert pf and demand
    assert all(e.channel == "flash_bg" for e in pf)
    assert all(e.channel == "flash" for e in demand)
    assert trc.makespan() == max(e.end for e in trc.events
                                 if e.channel != "flash_bg")


def test_attribution_stamped():
    _, trc = _traced_replay(async_io=True)
    slices = [e for e in trc.events
              if e.kind in ("fill", "dram_read") and e.layer >= 0]
    assert slices
    assert all(e.slice_kind in ("msb", "lsb") for e in slices)
    assert all(e.bits > 0 for e in slices)
    decode = [e for e in trc.events if e.phase == "decode"]
    prefill = [e for e in trc.events if e.phase == "prefill"]
    assert decode and prefill
    assert all(e.step >= 0 for e in decode)
    steps = sorted({e.step for e in decode})
    assert steps == list(range(len(steps)))


def test_replay_replay_equivalence():
    _, a = _traced_replay(async_io=True, ep_shards=2)
    _, b = _traced_replay(async_io=True, ep_shards=2)
    assert events_equal(a.events, b.events)
    assert first_divergence(a.events, b.events) is None


def test_divergence_detected():
    _, a = _traced_replay(async_io=True)
    _, b = _traced_replay(async_io=False)
    assert not events_equal(a.events, b.events)
    assert first_divergence(a.events, b.events) is not None


def test_clone_detaches_tracer():
    eng, trc = _traced_replay(async_io=True)
    led = eng.ledger
    copy = led.clone()
    assert led.tracer is trc
    assert copy.tracer is None
    n0 = len(trc.events)
    copy.dram_read(1024.0)
    assert len(trc.events) == n0
    fork = eng.clone()
    assert fork.tracer is None
    assert eng.tracer is trc


def test_sharded_clone_detaches_tracer():
    eng, trc = _traced_replay(async_io=True, ep_shards=2)
    led = eng.ledger
    copy = led.clone()
    assert led.tracer is trc and led.ici.tracer is trc
    assert copy.tracer is None and copy.ici.tracer is None
    n0 = len(trc.events)
    copy.shards[0].dram_read(1024.0)
    copy.migrate(512.0)
    assert len(trc.events) == n0


def test_force_sharded_rewires_tracer():
    """A tracer attached before ``force_sharded`` rebuilds the ledger
    follows the new ledger: its shards and the interconnect."""
    tr = zipf_trace(SyntheticSpec(), n_requests=2, prompt_len=8,
                    decode_steps=4, seed=0,
                    engine_overrides={"async_io": True})
    eng = ReplayEngine(tr.meta)
    trc = eng.attach_tracer(TimelineTracer())
    eng.force_sharded(2)
    assert eng.ledger.tracer is trc and eng.ledger.ici.tracer is trc
    eng.consume_all(tr.events)
    eng.finish()
    snap = eng.ledger.snapshot()
    assert sum(e.kind == "matmul" for e in trc.events) == snap["n_matmuls"]
    assert {e.shard for e in trc.events} >= {0, 1}


# ==========================================================================
# Chrome-trace export + report (port)
# ==========================================================================
def test_chrome_export_schema(tmp_path):
    _, trc = _traced_replay(async_io=True, ep_shards=2, prefetch_top_m=2)
    trc.span("queue", "req0", 0.0, 1e-4, request=0)
    path = str(tmp_path / "trace.json")
    data = export_chrome_trace(trc, path)
    on_disk = load_trace(path)
    assert on_disk == data
    evs = data["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == len(trc.events) + len(trc.spans)
    pnames = {e["pid"]: e["args"]["name"] for e in meta
              if e["name"] == "process_name"}
    assert pnames[0] == "shard 0" and pnames[1] == "shard 1"
    assert pnames[INTERCONNECT_PID] == "interconnect"
    assert pnames[REQUESTS_PID] == "requests"
    bg = [e for e in xs if e["pid"] in (0, 1)
          and e["tid"] == CHANNEL_TIDS["flash_bg"]]
    assert bg and all(e["cat"] == "prefetch_fill" for e in bg)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    span = [e for e in xs if e["pid"] == REQUESTS_PID]
    assert len(span) == 1 and span[0]["name"] == "queue"


def test_trace_report_totals(tmp_path):
    eng, trc = _traced_replay(async_io=True, ep_shards=2)
    rep = trace_report(chrome_trace(trc))
    assert rep["makespan_us"] == pytest.approx(trc.makespan() * 1e6,
                                               rel=1e-9)
    assert sum(r["events"] for r in rep["channels"]) == len(trc.events)
    snap = eng.ledger.snapshot()
    total_bytes = sum(r["bytes"] for r in rep["channels"])
    expect = snap["flash_bytes"] + snap["dram_bytes"] + snap["ici_bytes"]
    assert total_bytes == pytest.approx(expect, rel=1e-6)
    text = format_trace_report(rep)
    assert "makespan" in text and "shard 0" in text and "shard 1" in text


def test_trace_report_script(tmp_path):
    """``scripts/torch_trace_report.py`` on an exported file: its JSON is
    ``trace_report`` of the file, its tables name every shard."""
    eng, trc = _traced_replay(async_io=True, ep_shards=2)
    path = str(tmp_path / "trace.json")
    eng.export_trace(path)
    script = os.path.join(ROOT, "scripts", "torch_trace_report.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, script, path, "--json"],
                         capture_output=True, text=True, check=True,
                         env=env)
    assert json.loads(out.stdout) == json.loads(json.dumps(
        trace_report(load_trace(path))))
    text = subprocess.run([sys.executable, script, path],
                          capture_output=True, text=True, check=True,
                          env=env).stdout
    assert "makespan" in text and "shard 1" in text \
        and "interconnect" in text


# ==========================================================================
# Metrics registry (port)
# ==========================================================================
class TestMetrics:
    def test_counter_monotonic(self):
        r = MetricsRegistry()
        c = r.counter("x_total")
        c.inc()
        c.inc(2.0)
        assert c.value == 3.0
        with pytest.raises(ValueError):
            c.inc(-1.0)
        c.set_to(5.0)
        with pytest.raises(ValueError):
            c.set_to(4.0)

    def test_family_kind_conflict(self):
        r = MetricsRegistry()
        r.counter("x_total")
        with pytest.raises(TypeError):
            r.gauge("x_total")

    def test_labels_are_distinct_instruments(self):
        r = MetricsRegistry()
        a = r.counter("t_total", tenant="a")
        b = r.counter("t_total", tenant="b")
        assert a is not b
        a.inc(3)
        assert r.counter("t_total", tenant="a").value == 3.0
        assert r.counter("t_total", tenant="b").value == 0.0

    def test_histogram_buckets(self):
        r = MetricsRegistry()
        h = r.histogram("lat_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 5.0, 50.0, float("nan")):
            h.observe(v)
        assert h.count == 4 and h.counts == [1, 1, 1]   # 50 overflows
        assert h.cumulative() == [(0.1, 1), (1.0, 2), (10.0, 3)]

    def test_sample_series_and_jsonl(self, tmp_path):
        r = MetricsRegistry()
        c = r.counter("a_total")
        g = r.gauge("b")
        for i in range(3):
            c.inc()
            g.set(i * 0.5)
            r.sample(t=i * 1e-3, step=i)
        assert [row["a_total"] for row in r.series] == [1.0, 2.0, 3.0]
        path = str(tmp_path / "m.jsonl")
        assert r.to_jsonl(path) == 3
        with open(path) as fh:
            rows = [json.loads(line) for line in fh]
        assert rows == r.series

    def test_prometheus_text(self):
        r = MetricsRegistry()
        r.counter("a_total", "help a").inc(2)
        r.gauge("g", tenant="x").set(1.5)
        r.histogram("h_seconds", buckets=(0.1, 1.0)).observe(0.05)
        txt = r.prometheus_text()
        assert "# HELP a_total help a" in txt
        assert "# TYPE a_total counter" in txt
        assert 'g{tenant="x"} 1.5' in txt
        assert 'h_seconds_bucket{le="+Inf"} 1' in txt
        assert "h_seconds_count 1" in txt
        assert txt.endswith("\n")


def _step(t, n_active=2, miss=0.25, lat=1e-3, e=1e-3, *, ns=PORT, **kw):
    return ns.telemetry.StepRecord(t=t, n_active=n_active, miss_rate=miss,
                                   latency_s=lat, energy_j=e, **kw)


class TestMetricsSampler:
    def test_counters_monotonic_over_series(self):
        r = MetricsRegistry()
        s = MetricsSampler(r)
        tel = FleetTelemetry()
        tel.add_listener(s)
        for i in range(5):
            tel.on_step(_step(t=i * 1e-3, per_tenant={
                "a": {"tokens": 2, "accesses": 10, "misses": i}}))
        for key in r.series[-1]:
            if key.endswith("_total"):
                vals = [row.get(key, 0.0) for row in r.series]
                assert all(b >= a for a, b in zip(vals, vals[1:])), key
        assert r.series[-1]["decode_steps_total"] == 5.0
        assert r.series[-1]['tenant_tokens_total{tenant="a"}'] == 10.0

    def test_window_reset_fold(self):
        r = MetricsRegistry()
        s = MetricsSampler(r)
        c = r.counter("cache_accesses_total")
        s._fold_window(c, "k", 10.0)
        s._fold_window(c, "k", 15.0)
        s._fold_window(c, "k", 4.0)    # upstream reset mid-window
        assert c.value == 19.0

    def test_schema_identical_without_io_fields(self):
        ra, rs = MetricsRegistry(), MetricsRegistry()
        ta, ts = FleetTelemetry(), FleetTelemetry()
        ta.add_listener(MetricsSampler(ra))
        ts.add_listener(MetricsSampler(rs))
        ta.on_step(_step(t=1e-3, io_stall_s=5e-4, overlap_saved_s=1e-4))
        ts.on_step(_step(t=1e-3))
        assert set(ra.series[0]) == set(rs.series[0])
        assert rs.series[0]["io_stall_seconds_total"] == 0.0
        assert rs.series[0]["overlap_saved_seconds_total"] == 0.0


# ==========================================================================
# Telemetry schema + percentile/format_summary (port)
# ==========================================================================
class TestTelemetrySchema:
    def test_step_record_defaults(self):
        s = _step(t=0.0)
        assert s.io_stall_s == 0.0 and s.overlap_saved_s == 0.0

    def test_summary_schema_identical_sync_async(self):
        def run(with_io):
            tel = FleetTelemetry()
            rec = RequestRecord(request_id=0, arrival_t=0.0, admit_t=0.0,
                                first_token_t=1e-3, finish_t=3e-3,
                                n_generated=3)
            tel.on_submit(rec)
            kw = {"io_stall_s": 4e-4, "overlap_saved_s": 1e-4} \
                if with_io else {}
            tel.on_step(_step(t=1e-3, **kw))
            return tel.summary()
        sa, ss = run(True), run(False)
        assert set(sa) == set(ss)
        for key in ("decode_io_stall_s", "decode_overlap_saved_s",
                    "decode_io_stall_frac", "decode_overlap_saved_frac"):
            assert ss[key] == 0.0

    def test_empty_fleet_summary_is_well_defined(self):
        s = FleetTelemetry().summary()
        assert s["n_requests"] == 0 and s["n_tokens"] == 0
        assert math.isnan(s["ttft_p50_s"])
        assert math.isnan(s["throughput_tok_per_s"])
        assert s["decode_io_stall_s"] == 0.0
        assert "serving summary" in format_summary(s)


class TestPercentile:
    def test_empty_returns_nan(self):
        assert math.isnan(percentile([], 50))

    def test_single_sample_is_every_percentile(self):
        for p in (0, 1, 50, 95, 99, 100):
            assert percentile([7.0], p) == 7.0

    def test_nearest_rank(self):
        vals = [1.0, 2.0, 3.0, 4.0]
        assert percentile(vals, 0) == 1.0
        assert percentile(vals, 25) == 1.0
        assert percentile(vals, 50) == 2.0
        assert percentile(vals, 100) == 4.0

    def test_numpy_array_input(self):
        arr = np.array([3.0, 1.0, 2.0])
        out = percentile(arr, 50)
        assert out == 2.0 and type(out) is float
        assert math.isnan(percentile(np.array([]), 95))
        assert percentile(np.float32([5.0, 6.0]), 95) == 6.0

    def test_out_of_range_raises_even_when_empty(self):
        with pytest.raises(ValueError):
            percentile([], 101)
        with pytest.raises(ValueError):
            percentile([1.0], -0.1)


class TestFormatSummary:
    def test_numpy_scalars_render_as_numbers(self):
        txt = format_summary({"a": np.float32(0.25), "b": np.int64(3),
                              "c": float("nan")})
        assert "0.25" in txt and ": 3" in txt and "nan" in txt
        assert "float32" not in txt

    def test_list_of_dicts_renders_rows(self):
        txt = format_summary({"per_shard": [
            {"shard": 0, "miss_rate": 0.1},
            {"shard": 1, "miss_rate": 0.2}]})
        assert "[0]" in txt and "[1]" in txt and "miss_rate" in txt

    def test_scalar_list_inline(self):
        txt = format_summary({"curve": [0.1, 0.2, 0.30000001]})
        assert "[0.1, 0.2, 0.3]" in txt

    def test_empty_and_nested(self):
        txt = format_summary({"outer": {"inner": {}}, "n": 0})
        assert "outer" in txt and "inner" in txt


# ==========================================================================
# Both packages on the same scenario
# ==========================================================================
PARITY_CONFIGS = CONFIGS + [
    {"prefetch_top_m": 2, "prefetch_kind": "transition"},
    {"async_io": True, "prefetch_top_m": 2, "prefetch_kind": "transition"},
    {"ep_shards": 2, "placement": "hotness", "placement_period": 3,
     "replicate_k": 1},
]
PARITY_IDS = IDS + ["sync_transition", "async_transition",
                    "sync_ep2_hotness_replicate"]


def _events(trc):
    return [dataclasses.asdict(e) for e in trc.events]


def _max_rel_diff(ref, port):
    """Largest relative difference of the events' float fields."""
    worst = 0.0
    for a, b in zip(ref, port):
        for f in ("start", "end", "nbytes", "ops"):
            x, y = a[f], b[f]
            if x != y:
                worst = max(worst, abs(x - y) / max(abs(x), abs(y)))
    return worst


@pytest.mark.parametrize("over", PARITY_CONFIGS, ids=PARITY_IDS)
def test_traced_replay_matches_reference(over):
    """Event streams, chrome_trace dicts, trace reports and the replay
    report agree across the packages."""
    seen = {}

    def scenario(ns):
        eng, trc = _traced_replay(ns, **over)
        seen[ns is PORT] = _events(trc)
        return {"events": _events(trc), "chrome": ns.obs.chrome_trace(trc),
                "report": ns.obs.trace_report(ns.obs.chrome_trace(trc)),
                "makespans": sorted(trc.channel_makespans().items()),
                "replay": report_view(eng.finish())}

    port = run_both(scenario)
    assert port["events"], "empty capture"
    assert {e["kind"] for e in port["events"]} >= {"fill", "dram_read",
                                                  "matmul"}
    assert _max_rel_diff(seen[False], seen[True]) <= 1e-6


@pytest.mark.parametrize("over", [CONFIGS[1], CONFIGS[3]],
                         ids=[IDS[1], IDS[3]])
def test_trace_report_reads_either_packages_file(over, tmp_path):
    """Each package's ``trace_report`` of the other's exported file equals
    the other's own report; ``load_trace`` reads both."""
    files, reports = {}, {}
    for ns, name in ((REF, "ref"), (PORT, "port")):
        _, trc = _traced_replay(ns, **over)
        trc.span("queue", "req0", 0.0, 1e-4, request=0)
        path = str(tmp_path / f"{name}.json")
        ns.obs.export_chrome_trace(trc, path)
        files[name] = path
        reports[name] = ns.obs.trace_report(ns.obs.load_trace(path))
    assert_same(reports["ref"],
                PORT.obs.trace_report(PORT.obs.load_trace(files["ref"])))
    assert_same(reports["port"],
                REF.obs.trace_report(REF.obs.load_trace(files["port"])))
    assert_same(reports["ref"], reports["port"])
    assert PORT.obs.format_trace_report(reports["port"]) == \
        REF.obs.format_trace_report(reports["ref"])


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_tracer_is_a_pure_sink(over):
    """A traced replay and an untraced one give the same ledger, miss
    counts and report, exactly."""
    traced, _ = _traced_replay(**over)
    bare, trc = _traced_replay(trace=False, **over)
    assert trc is None
    assert traced.ledger.snapshot() == bare.ledger.snapshot()
    a, b = report_view(traced.finish()), report_view(bare.finish())
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


def _step_stream(ns):
    out = []
    for i in range(6):
        kw = {"io_stall_s": 1e-4 * i, "overlap_saved_s": 5e-5} if i % 2 \
            else {}
        out.append(_step(t=(i + 1) * 1e-3, n_active=1 + i % 3,
                         miss=0.1 * i, lat=2e-3 + 1e-4 * i, e=1e-3 * i,
                         ns=ns,
                         per_tenant={"a": {"tokens": 1, "accesses": 8,
                                           "misses": i},
                                     "b": {"tokens": i % 2,
                                           "accesses": 4, "misses": 1}},
                         **kw))
    return out


def test_metrics_sampler_matches_reference():
    """The same StepRecords and requests into both packages' samplers:
    equal series, snapshots and Prometheus text."""
    def scenario(ns):
        reg = ns.obs.MetricsRegistry()
        tel = ns.telemetry.FleetTelemetry()
        tel.add_listener(ns.obs.MetricsSampler(reg))
        for rid in range(3):
            rec = ns.telemetry.RequestRecord(
                request_id=rid, arrival_t=0.0, admit_t=1e-4 * rid,
                first_token_t=1e-3 * (rid + 1), finish_t=5e-3,
                n_generated=3)
            tel.on_submit(rec)
            tel.on_first_token(rec)
        for s in _step_stream(ns):
            tel.on_step(s)
        return {"series": reg.series, "snapshot": reg.snapshot(),
                "prom": reg.prometheus_text()}

    run_both(scenario)


@pytest.mark.parametrize("over", [CONFIGS[1], CONFIGS[3]],
                         ids=[IDS[1], IDS[3]])
def test_metrics_sampler_engine_side_matches_reference(over):
    """The sampler reading a replayed engine (cache usage, shard counts,
    ledger traffic, prefetch outcomes) gives the same row in both
    packages, and its ledger counters equal the ledger snapshot."""
    def scenario(ns):
        eng, _ = _traced_replay(ns, trace=False, **over)
        reg = ns.obs.MetricsRegistry()
        tel = ns.telemetry.FleetTelemetry()
        tel.add_listener(ns.obs.MetricsSampler(reg, eng))
        for s in _step_stream(ns):
            tel.on_step(s)
        return {"series": reg.series, "prom": reg.prometheus_text(),
                "ledger": eng.ledger.snapshot()}

    port = run_both(scenario)
    last = port["series"][-1]
    for key in ("flash_bytes", "dram_bytes", "ici_bytes",
                "migration_bytes", "prefetch_flash_bytes"):
        assert last[f"{key}_total"] == port["ledger"][key]
    assert last["cache_capacity_bytes"] > 0
