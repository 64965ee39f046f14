"""Port parity: the live engine with expert parallelism, placement and the
SLO controller.

The 2-layer f32 ``qwen15-moe-repro`` (one numpy tree of weights for both
packages, the port's side through the bridge) serves the same requests,
alternating two tenants, through each package's continuous-batching
scheduler with a trace recorder attached, for ``ep_shards`` in {2, 4} x
placement in {round_robin, hotness (+ replicas)}, sync and async, with
and without prefetch, and for the SLO controller with two tenants and a
partitioned cache.  For each configuration:

* the port's live run equals the reference's: tokens, the recorded
  routing ids, per-epoch and per-shard miss counts, migrations,
  ``placement_summary``, the controller's summary and action log, and
  the telemetry's rejections exact; ledger at rtol 1e-6;
* the port's recorded trace, through a file, replays in the reference to
  the port's live run, and the reference's recorded trace replays in the
  port to the reference's live run (controller meta included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro import sim as JSim
from repro.configs.base import get_config
from repro.control import ControllerConfig as JCC
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.models.moe import RoutingPolicy as JRP
from repro.serving import scheduler as JS
from repro_torch import sim as TSim
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.control import ControllerConfig as TCC
from repro_torch.control import TenantPartitionedCache
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.serving import scheduler as TS

torch.set_num_threads(1)

KW = dict(cache_bytes=1.0e6, miss_rate_target=0.1, warmup="pcw",
          max_seq=24)
POLICY = dict(kind="cache_prior", slice_mode="dbsc")
CTL = dict(slos={"premium": {"miss_rate": 1e-6, "bit_floor": "high"},
                 "batch": {"miss_rate": 1e-6}},
           interval=2, window=8, cooldown=4)
CONFIGS = {
    "ep2_round_robin_sync": dict(ep_shards=2),
    "ep2_hotness_replicate_async": dict(
        ep_shards=2, placement="hotness", placement_period=2,
        replicate_k=1, async_io=True),
    "ep4_round_robin_async": dict(ep_shards=4, async_io=True),
    "ep4_hotness_replicate_sync": dict(
        ep_shards=4, placement="hotness", placement_period=2,
        replicate_k=2),
    "ep4_hotness_async_request_prefetch": dict(
        ep_shards=4, placement="hotness", placement_period=3,
        async_io=True, prefetch_top_m=4, prefetch_kind="request"),
    "controller_partition_sync": dict(controller=dict(CTL, partition=True)),
    "controller_partition_async_transition": dict(
        controller=dict(CTL, partition=True), async_io=True,
        prefetch_top_m=4, prefetch_kind="transition"),
    "controller_ep2_no_partition": dict(
        controller=dict(CTL, partition=False), ep_shards=2,
        placement="hotness", placement_period=2),
}
NAMES = sorted(CONFIGS)
TENANTS = ["premium", "batch"]


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


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 10).astype(np.int32) for _ in range(4)]


def _serve(sched_mod, engine, recorder, prompts, **sched_kw):
    sched = sched_mod.ContinuousBatchingScheduler(
        engine, sched_mod.SchedulerConfig(max_batch=2, max_queue=8),
        **sched_kw)
    ctl = engine.slo_controller
    if ctl is not None:
        assert ctl in sched.telemetry.listeners
        assert sched._admission_hook == ctl.admit_request
    rec = sched.attach_recorder(recorder)
    for i, p in enumerate(prompts):
        sched.submit(sched_mod.Request(request_id=i, prompt=p,
                                       max_new_tokens=4 + i,
                                       tenant=TENANTS[i % 2]))
    done = sched.run()
    cache = engine.cache
    return {
        "tokens": {c.request_id: np.asarray(c.tokens) for c in done},
        "epoch_counts": cache.epoch_counts(),
        "per_shard_epoch_counts": (cache.per_shard_epoch_counts()
                                   if hasattr(cache, "shards") else None),
        "shard_breakdown": engine.shard_breakdown(),
        "placement": engine.placement_summary(),
        "migration_events": list(engine.migration_events),
        "controller": (None if ctl is None else
                       {"summary": ctl.summary(), "actions": ctl.actions}),
        "budgets": (cache.budgets() if hasattr(cache, "set_budgets")
                    else None),
        "ledger": engine.ledger.snapshot(),
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "energy_curve": sched.telemetry.energy_curve(),
        "rejected": list(sched.telemetry.rejected),
        "per_tenant": sched.summary().get("per_tenant"),
        "trace": rec.trace(),
    }


@pytest.fixture(scope="module")
def runs(model):
    """name -> (reference run, port run), computed on first use."""
    cfg, tcfg, params, tparams = model
    prompts = _prompts(cfg.vocab_size)
    out, jitted = {}, {}

    def get(name):
        if name not in out:
            over = dict(KW, **CONFIGS[name])
            ctl = over.pop("controller", None)
            je = JPE(cfg, params, JEC(
                mat=JMat(8, 4), policy=JRP(**POLICY),
                controller=None if ctl is None else JCC.from_dict(ctl),
                **over))
            if jitted:     # the forward does not see the charge-path knobs
                je._jit_prefill, je._jit_decode = jitted["fns"]
            else:
                jitted["fns"] = je._jit_prefill, je._jit_decode
            te = TPE(tcfg, tparams, TEC(
                mat=TMat(8, 4), policy=TRP(**POLICY),
                controller=None if ctl is None else TCC.from_dict(ctl),
                **over), device="cpu")
            if ctl is not None and ctl["partition"]:
                assert isinstance(te.cache, TenantPartitionedCache)
            out[name] = (_serve(JS, je, JSim.TraceRecorder(), prompts),
                         _serve(TS, te, TSim.TraceRecorder(), prompts,
                                device="cpu"))
        return out[name]
    return get


def _assert_ledger_close(want: dict, got: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-15,
                                   err_msg=k)


def _routing(trace):
    return [(e.kind, np.asarray(e.ids).tolist()) for e in trace.events]


@pytest.mark.parametrize("name", NAMES)
def test_live_engine_matches_reference(runs, name):
    j, t = runs(name)
    assert sorted(t["tokens"]) == sorted(j["tokens"])
    for rid in j["tokens"]:
        np.testing.assert_array_equal(t["tokens"][rid], j["tokens"][rid])
    assert _routing(t["trace"]) == _routing(j["trace"])
    for key in ("epoch_counts", "per_shard_epoch_counts", "miss_curve",
                "migration_events", "rejected", "budgets"):
        assert_same(j[key], t[key])
    for key in ("shard_breakdown", "placement", "controller",
                "per_tenant", "energy_curve"):
        assert_same(j[key], t[key])
    _assert_ledger_close(j["ledger"], t["ledger"])
    over = CONFIGS[name]
    if over.get("ep_shards", 1) > 1:
        assert len(t["per_shard_epoch_counts"]) == over["ep_shards"]
        assert t["ledger"]["ici_bytes"] > 0
    if over.get("placement") == "hotness":
        assert t["migration_events"], "no migration within the run"
    if "controller" in over:
        assert t["controller"]["actions"], "the controller never acted"


@pytest.mark.parametrize("name", NAMES)
def test_port_trace_replays_in_reference(runs, name, tmp_path):
    _, t = runs(name)
    path = t["trace"].save(str(tmp_path / "port.npz"))
    rep = JSim.replay_trace(JSim.Trace.load(path))
    assert rep.miss_curve == t["miss_curve"]
    assert_same(rep.epoch_counts, t["epoch_counts"])
    assert_same(rep.per_shard_epoch_counts, t["per_shard_epoch_counts"])
    assert_same(rep.migration_events or [], t["migration_events"])
    if t["controller"] is not None:
        assert_same(rep.controller_summary, t["controller"]["summary"])
    _assert_ledger_close(t["ledger"], rep.ledger)


@pytest.mark.parametrize("name", NAMES)
def test_reference_trace_replays_in_port(runs, name, tmp_path):
    j, _ = runs(name)
    path = j["trace"].save(str(tmp_path / "reference.jsonl"))
    rep = TSim.replay_trace(TSim.Trace.load(path))
    assert rep.miss_curve == j["miss_curve"]
    assert_same(j["epoch_counts"], rep.epoch_counts)
    assert_same(j["per_shard_epoch_counts"], rep.per_shard_epoch_counts)
    assert_same(j["migration_events"], rep.migration_events or [])
    assert_same(j["placement"], rep.placement)
    if j["controller"] is not None:
        assert_same(j["controller"]["summary"], rep.controller_summary)
    _assert_ledger_close(j["ledger"], rep.ledger)


def test_admission_hook_rejection_path(model):
    _, tcfg, _, tparams = model
    engine = TPE(tcfg, tparams, TEC(mat=TMat(8, 4), policy=TRP(**POLICY),
                                    **KW), device="cpu")
    sched = TS.ContinuousBatchingScheduler(
        engine, TS.SchedulerConfig(max_batch=1, max_queue=8,
                                   admission_hook=lambda r: False),
        device="cpu")
    req = TS.Request(request_id=7, prompt=np.arange(6, dtype=np.int32),
                     max_new_tokens=2, tenant="premium")
    assert not sched.submit(req)
    assert sched.telemetry.rejected == [7]
