"""Port parity: observability on the live engine, the scheduler and the
server.

The 2-layer ``qwen15-moe-repro`` at ``tests/test_obs.py``'s live setting
(MAT84, Cache-Prior + DBSC, a 1e6 B cache, PCW, ``async_io``; f32 and one
numpy tree of weights for both packages, the port's side through the
bridge) serves a closed-loop workload of 3 requests with a timeline
tracer, a metrics registry and a trace recorder attached, at
``ep_shards`` 1 and 2:

* the port's live event stream equals its own replay of the recorded
  trace, through a file, exactly, and the two Chrome exports agree
  outside the requests process;
* the port's live events, spans, Chrome export, trace report and metrics
  series equal the reference's (ids, kinds, attribution exact; floats at
  rtol 1e-6);
* a run without the tracer gives the same tokens, routing ids, miss
  counts and ledger, exactly;
* the metrics series has one row per decode step, non-decreasing
  counters, and ledger counters equal to the ledger snapshot.

The server's four hooks and the sharded ledger's tracer fan-out are
checked on the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro import obs as JO
from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.models.moe import RoutingPolicy as JRP
from repro.serving import scheduler as JS
from repro.serving import workloads as JW
from repro.sim import TraceRecorder as JRecorder
from repro_torch import obs as TO
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.hw.energy import ShardedCostLedger
from repro_torch.hw.specs import SYSTEM_PROFILES
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.serving import scheduler as TS
from repro_torch.serving import workloads as TW
from repro_torch.serving.server import SliceMoEServer
from repro_torch.sim import ReplayEngine, Trace, TraceRecorder

torch.set_num_threads(1)

KW = dict(mat=(8, 4), cache_bytes=1.0e6, miss_rate_target=0.1,
          warmup="pcw", max_seq=64, async_io=True)
POLICY = dict(kind="cache_prior", slice_mode="dbsc")
LEDGER_COUNTERS = ("flash_bytes", "dram_bytes", "ici_bytes",
                   "migration_bytes", "prefetch_flash_bytes")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _workload(W, vocab):
    return W.generate(W.WorkloadConfig(
        kind="closed_loop", n_requests=3, seed=0,
        tenants=(W.TenantSpec(prompt_len=W.LengthDist("fixed", 12),
                              output_len=W.LengthDist("fixed", 6)),)),
        vocab)


def _engine_cfg(EC, Mat, RP, ep):
    kw = dict(KW, ep_shards=ep)
    mat = kw.pop("mat")
    return EC(mat=Mat(*mat), policy=RP(**POLICY), **kw)


def _serve(sched_mod, W, obs, engine, vocab, traced, **sched_kw):
    tracer = engine.attach_tracer(obs.TimelineTracer()) if traced else None
    sched = sched_mod.ContinuousBatchingScheduler(
        engine, sched_mod.SchedulerConfig(max_batch=2, max_queue=8),
        **sched_kw)
    rec = sched.attach_recorder(
        TraceRecorder() if obs is TO else JRecorder())
    reg = sched.attach_metrics(obs.MetricsRegistry())
    reqs = _workload(W, vocab)
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    return {
        "prompts": [np.asarray(r.prompt).tolist() for r in reqs],
        "tokens": {c.request_id: np.asarray(c.tokens).tolist()
                   for c in done},
        "routing": [(e.kind, np.asarray(e.ids).tolist())
                    for e in rec.trace().events],
        "epoch_counts": engine.cache.epoch_counts(),
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "ledger": engine.ledger.snapshot(),
        "n_steps": len(sched.telemetry.steps),
        "tracer": tracer,
        "series": reg.series,
        "trace": rec.trace(),
    }


@pytest.fixture(scope="module")
def runs(model):
    """(package, ep, traced) -> run, computed on first use."""
    cfg, tcfg, params, tparams = model
    out, jitted = {}, {}

    def get(pkg, ep, traced=True):
        key = (pkg, ep, traced)
        if key not in out:
            if pkg == "ref":
                je = JPE(cfg, params, _engine_cfg(JEC, JMat, JRP, ep))
                if jitted:    # the forward does not see the charge path
                    je._jit_prefill, je._jit_decode = jitted["fns"]
                else:
                    jitted["fns"] = je._jit_prefill, je._jit_decode
                out[key] = _serve(JS, JW, JO, je, cfg.vocab_size, traced)
            else:
                te = TPE(tcfg, tparams, _engine_cfg(TEC, TMat, TRP, ep),
                         device="cpu")
                out[key] = _serve(TS, TW, TO, te, tcfg.vocab_size, traced,
                                  device="cpu")
        return out[key]
    return get


def _hw(export):
    return [e for e in export["traceEvents"]
            if e.get("pid") != TO.timeline.REQUESTS_PID]


@pytest.mark.parametrize("ep", [1, 2])
def test_live_replay_trace_equivalence(runs, ep, tmp_path):
    """The port's live capture equals its replay of the recorded trace."""
    live = runs("port", ep)
    live_trc = live["tracer"]
    loaded = Trace.load(live["trace"].save(str(tmp_path / "live.npz")))
    rep_eng = ReplayEngine(loaded.meta)
    rep_trc = rep_eng.attach_tracer(TO.TimelineTracer())
    rep_eng.consume_all(loaded.events)
    rep_eng.finish()

    div = TO.first_divergence(live_trc.events, rep_trc.events)
    assert div is None, (
        f"divergence at event {div}: "
        f"{live_trc.events[div] if div < len(live_trc.events) else '<end>'}"
        f" vs "
        f"{rep_trc.events[div] if div < len(rep_trc.events) else '<end>'}")
    assert TO.events_equal(live_trc.events, rep_trc.events)
    assert _hw(TO.chrome_trace(live_trc)) == _hw(TO.chrome_trace(rep_trc))
    kinds = {e.kind for e in live_trc.events}
    assert {"fill", "dram_read", "matmul"} <= kinds
    if ep > 1:
        assert "a2a" in kinds


@pytest.mark.parametrize("ep", [1, 2])
def test_live_trace_matches_reference(runs, ep):
    j, t = runs("ref", ep), runs("port", ep)
    assert t["prompts"] == j["prompts"]
    assert t["tokens"] == j["tokens"]
    assert t["routing"] == j["routing"]
    jt, tt = j["tracer"], t["tracer"]
    assert len(tt.events) == len(jt.events) > 0
    assert_same([dataclasses.asdict(e) for e in jt.events],
                [dataclasses.asdict(e) for e in tt.events])
    assert_same(jt.spans, tt.spans)
    names = {s["name"] for s in tt.spans}
    assert names == {"queue", "prefill", "decode_step", "decode", "retire"}
    j_export, t_export = JO.chrome_trace(jt), TO.chrome_trace(tt)
    assert_same(j_export, t_export)
    assert_same(JO.trace_report(j_export), TO.trace_report(t_export))
    assert_same(j["series"], t["series"])


@pytest.mark.parametrize("ep", [1, 2])
def test_tracer_changes_nothing_live(runs, ep):
    """The tracer is a pure sink: tokens, routing ids, miss counts and
    every ledger figure are the same without it, exactly."""
    traced, bare = runs("port", ep), runs("port", ep, traced=False)
    assert bare["tracer"] is None
    for key in ("tokens", "routing", "epoch_counts", "miss_curve",
                "ledger"):
        assert traced[key] == bare[key], key
    assert traced["series"] == bare["series"]


@pytest.mark.parametrize("ep", [1, 2])
def test_live_metrics_series(runs, ep):
    run = runs("port", ep)
    series = run["series"]
    assert len(series) == run["n_steps"] > 0
    assert [row["step"] for row in series] == list(range(len(series)))
    for key in series[-1]:
        if key.endswith("_total"):
            vals = [row.get(key, 0.0) for row in series]
            assert all(b >= a for a, b in zip(vals, vals[1:])), key
    for key in LEDGER_COUNTERS:
        np.testing.assert_allclose(series[-1][f"{key}_total"],
                                   run["ledger"][key], rtol=1e-6)
    assert series[-1]["decode_steps_total"] == run["n_steps"]


def test_server_hooks(model, tmp_path):
    """attach_tracer / attach_metrics / attach_recorder before the engine
    exists wire in at the first run; export_trace writes the capture; the
    recorded trace replays to the same events."""
    _, tcfg, _, tparams = model
    srv = SliceMoEServer(tcfg, tparams, _engine_cfg(TEC, TMat, TRP, 1),
                         max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="attach_tracer"):
        srv.export_trace(str(tmp_path / "none.json"))
    trc = srv.attach_tracer(TO.TimelineTracer())
    reg = srv.attach_metrics(TO.MetricsRegistry())
    rec = srv.attach_recorder(TraceRecorder())
    for r in _workload(TW, tcfg.vocab_size)[:2]:
        srv.submit(r)
    done = srv.run()
    assert len(done) == 2
    eng = srv._engine
    assert eng.tracer is trc and eng.ledger.tracer is trc
    assert eng.recorder is rec
    data = srv.export_trace(str(tmp_path / "server.json"))
    assert data == TO.load_trace(str(tmp_path / "server.json"))
    assert {s["track"] for s in trc.spans} == {"req0", "req1", "steps"}
    assert len(reg.series) == len(srv.last_scheduler.telemetry.steps) > 0
    rep = ReplayEngine(rec.trace().meta)
    rep_trc = rep.attach_tracer(TO.TimelineTracer())
    rep.consume_all(rec.trace().events)
    rep.finish()
    assert TO.events_equal(trc.events, rep_trc.events)
    # a second run reuses the engine and the registry
    srv.submit(_workload(TW, tcfg.vocab_size)[2])
    n_rows = len(reg.series)
    srv.run()
    assert len(reg.series) > n_rows and eng.tracer is trc


def test_sharded_ledger_attach_tracer_fans_out():
    led = ShardedCostLedger(SYSTEM_PROFILES["mobile_soc"], 2)
    trc = TO.TimelineTracer()
    led.attach_tracer(trc)
    assert led.tracer is trc and led.ici.tracer is trc
    assert [s.shard_id for s in led.shards] == [0, 1]
    assert led.ici.shard_id == -1
    led.shards[1].dram_read(1024.0)
    led.ici_transfer(64.0)
    led.migrate(32.0)
    assert [(e.kind, e.channel, e.shard) for e in trc.events] == [
        ("dram_read", "dram", 1), ("a2a", "ici", -1),
        ("migrate", "ici", -1)]
    led.attach_tracer(None)
    assert led.tracer is None and led.ici.tracer is None
    led.shards[0].dram_read(1.0)
    assert len(trc.events) == 3
