"""The host-clock spans of the serving path (``repro_torch.obs.spans``).

The 2-layer f32 ``qwen15-moe-repro`` of ``tests/test_torch_obs_live.py``'s
live setting (MAT84, Cache-Prior + DBSC, a 1e6 B cache, PCW,
``async_io``), built from the port's own init, serves 3 closed-loop
requests at ``max_batch`` 2 on the CPU:

* one step record per scheduler step, the last one (nothing left to
  decode) included; each decode step's record holds every span, nested
  spans within their parent, and a step's spans within its host wall;
* under ``torch.profiler`` the spans are ranges with their exact names,
  ``to_host`` and ``replay`` inside ``slicemoe.decode_charge`` and the
  scheduler's spans outside every engine range;
* a run under the profiler serves the same tokens, routing and charge
  counters as one without it;
* a second scheduler built and run while the first lives keeps records
  of its own, and leaves the first one's as a run alone makes them.

The recorder itself (reset, the deque's bound, absolute indices, the
claim) and the span without a profiler are checked without a model.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.core.amat import MatConfig
from repro_torch.core.engine import EngineConfig, PersistentEngine
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy
from repro_torch.obs import spans as S
from repro_torch.serving import scheduler as TS
from repro_torch.serving import workloads as TW
from repro_torch.sim import TraceRecorder

torch.set_num_threads(1)

ENGINE = ("slicemoe.prefill_forward", "slicemoe.prefill_charge",
          "slicemoe.decode_forward", "slicemoe.decode_charge")
NESTED = ("slicemoe.decode_charge.to_host", "slicemoe.decode_charge.replay")
SCHED = ("slicemoe.sched.prepare", "slicemoe.sched.sample",
         "slicemoe.sched.update")
DECODE = ("slicemoe.decode_forward", "slicemoe.decode_charge") + NESTED \
    + SCHED
# The spans no other span holds.
TOP = ENGINE + SCHED


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    return cfg, TM.init_params(cfg, seed=0, device="cpu")


def _engine(model):
    cfg, params = model
    return PersistentEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=1.0e6, miss_rate_target=0.1,
        warmup="pcw", max_seq=64, async_io=True,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc")),
        device="cpu")


def _scheduler(model):
    cfg, _ = model
    sched = TS.ContinuousBatchingScheduler(
        _engine(model), TS.SchedulerConfig(max_batch=2, max_queue=8),
        device="cpu")
    for r in TW.generate(TW.WorkloadConfig(
            kind="closed_loop", n_requests=3, seed=0,
            tenants=(TW.TenantSpec(prompt_len=TW.LengthDist("fixed", 12),
                                   output_len=TW.LengthDist("fixed", 6)),)),
            cfg.vocab_size):
        sched.submit(r)
    return sched


def _serve(model, between=None):
    """Serve the workload one ``step()`` at a time, calling ``between``
    after the second step.  Returns what was served and, per step, its
    host wall and whether it decoded."""
    sched = _scheduler(model)
    engine = sched.engine
    rec = sched.attach_recorder(TraceRecorder())
    walls, decoded = [], []
    more = True
    while more:
        n = len(sched.wall_step_s)
        t0 = time.perf_counter()
        more = sched.step()
        walls.append(time.perf_counter() - t0)
        decoded.append(len(sched.wall_step_s) == n + 1)
        if between is not None and len(walls) == 2:
            between()
    return {
        "tokens": {c.request_id: np.asarray(c.tokens).tolist()
                   for c in sched.completions},
        "routing": [(e.kind, np.asarray(e.ids).tolist())
                    for e in rec.trace().events],
        "epoch_counts": engine.cache.epoch_counts(),
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "ledger": engine.ledger.snapshot(),
        "walls": walls, "decoded": decoded,
        "records": [dict(sched.spans.step(k))
                    for k in range(sched.spans.n_steps)],
        "spans": sched.spans,
    }


@pytest.fixture(scope="module")
def served(model):
    return _serve(model)


@pytest.fixture(scope="module")
def profiled(model):
    """The same run under ``torch.profiler`` (CPU activity), with the
    host intervals of its ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _serve(model)
    ranges = {}
    for ev in prof.events():
        if ev.name in DECODE + ENGINE:
            ranges.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    out["ranges"] = ranges
    return out


def test_one_record_per_scheduler_step(served):
    records, decoded = served["records"], served["decoded"]
    assert len(records) == len(served["walls"])
    # The last step found nothing to decode, and recorded nothing.
    assert decoded[-1] is False and records[-1] == {}
    assert sum(decoded) == len(records) - 1
    for rec, dec in zip(records, decoded):
        if dec:
            assert set(DECODE) <= set(rec)
            assert all(rec[n] > 0 for n in DECODE)
    # Admissions: the first step admits two requests, whose prefills
    # add up under one name; the third is admitted when a slot frees.
    with_prefill = [k for k, r in enumerate(records)
                    if "slicemoe.prefill_forward" in r]
    assert with_prefill[0] == 0 and len(with_prefill) == 2
    assert all("slicemoe.prefill_charge" in records[k]
               for k in with_prefill)


def test_nested_spans_and_step_walls(served):
    for rec, wall, dec in zip(served["records"], served["walls"],
                              served["decoded"]):
        if dec:
            charge = rec["slicemoe.decode_charge"]
            to_host = rec["slicemoe.decode_charge.to_host"]
            replay = rec["slicemoe.decode_charge.replay"]
            assert to_host <= charge and replay <= charge
            assert to_host + replay <= charge
        assert sum(rec.get(n, 0.0) for n in TOP) <= wall


def test_profiler_ranges_and_nesting(profiled):
    ranges = profiled["ranges"]
    for name in ENGINE + NESTED + SCHED:
        assert name in ranges, name
    n_decode = sum(profiled["decoded"])
    for name in DECODE:
        assert len(ranges[name]) == n_decode, name
    charge = ranges["slicemoe.decode_charge"]
    for name in NESTED:
        for s, e in ranges[name]:
            assert any(cs <= s and e <= ce for cs, ce in charge), name
    engine = [se for n in ENGINE + NESTED for se in ranges[n]]
    for name in SCHED:
        for s, e in ranges[name]:
            assert all(e <= es or ee <= s for es, ee in engine), name


def test_profiler_changes_nothing_served(served, profiled):
    for key in ("tokens", "routing", "epoch_counts", "miss_curve",
                "ledger", "decoded"):
        assert profiled[key] == served[key], key
    # The step records hold the same spans, with or without a profiler.
    assert [set(r) for r in profiled["records"]] == \
        [set(r) for r in served["records"]]


def test_span_launches_nothing():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with S.span("slicemoe.test.empty"):
            pass
    names = [ev.name for ev in prof.events()]
    assert names == ["slicemoe.test.empty"]


def test_recorder_reset_and_bound():
    rec = S.SpanRecorder(max_steps=3)
    S.add("a", 1.0)                     # no open step: not recorded
    assert rec.n_steps == 0
    for k in range(5):
        assert rec.open_step() == k
        S.add("a", float(k))
        S.add("a", 0.5)                 # a second span of one name adds
    S.close_step()
    S.add("a", 1.0)                     # the step is closed
    assert rec.n_steps == 5
    assert [rec.step(k)["a"] for k in range(2, 5)] == [2.5, 3.5, 4.5]
    for k in (0, 1, 5, -1):
        with pytest.raises(IndexError):
            rec.step(k)
    rec.reset()
    assert rec.n_steps == 0
    assert rec.open_step() == 0 and rec.step(0) == {}
    S.close_step()


def test_span_records_into_the_open_step():
    rec = S.SpanRecorder()
    with S.span("slicemoe.test.outside"):
        pass
    k = rec.open_step()
    t0 = time.perf_counter()
    with S.span("slicemoe.test.outer"):
        with S.span("slicemoe.test.inner"):
            time.sleep(0.002)
    wall = time.perf_counter() - t0
    S.close_step()
    with S.span("slicemoe.test.after"):
        pass
    assert rec.n_steps == 1
    assert set(rec.step(k)) == {"slicemoe.test.outer",
                                "slicemoe.test.inner"}
    assert 0.002 <= rec.step(k)["slicemoe.test.inner"] \
        <= rec.step(k)["slicemoe.test.outer"] <= wall


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name} opened with no profiler")
    monkeypatch.setattr(S, "record_function", no_range)
    rec = S.SpanRecorder()
    rec.open_step()
    with S.span("slicemoe.test.plain"):
        pass
    S.close_step()
    assert set(rec.step(0)) == {"slicemoe.test.plain"}


def test_recorder_claim():
    class Owner:
        pass
    rec = S.SpanRecorder(max_steps=4)
    a, b = Owner(), Owner()
    assert rec.claim(a) is rec and rec.claim(a) is rec
    other = rec.claim(b)                # a lives: b gets its own
    assert other is not rec and other.claim(b) is other
    del a                               # a is gone: b may take it
    assert rec.claim(b) is rec


def test_scheduler_resets_the_recorder(model, monkeypatch):
    stale = S.SpanRecorder()
    stale.open_step()
    S.add("slicemoe.test.stale", 1.0)
    S.close_step()
    monkeypatch.setattr(TS, "SPANS", stale)
    sched = TS.ContinuousBatchingScheduler(_engine(model), device="cpu")
    assert sched.spans is stale and stale.n_steps == 0


def test_a_second_scheduler_keeps_its_own_records(model, served,
                                                  monkeypatch):
    """A scheduler built and run to its end between the first one's
    steps (as ``sim/trace.py``'s recording does) neither clears nor
    writes into the first one's records."""
    monkeypatch.setattr(TS, "SPANS", S.SpanRecorder())
    second = {}

    def run_second():
        sched = _scheduler(model)
        sched.run()
        second["sched"] = sched

    out = _serve(model, between=run_second)
    assert out["spans"] is TS.SPANS
    other = second["sched"].spans
    assert other is not TS.SPANS
    # The first one's records are those of a run alone, step for step.
    assert [set(r) for r in out["records"]] == \
        [set(r) for r in served["records"]]
    assert len(out["records"]) == len(served["records"])
    # The second one's hold its own steps, every decode span in each.
    assert 0 < other.n_steps == len(served["records"])
    for k in range(other.n_steps - 1):
        assert set(DECODE) <= set(other.step(k))
