"""Port parity: the live engine's async timeline and prefetch, and replay.

The 2-layer f32 ``qwen15-moe-repro`` (one numpy tree of weights for both
packages, the port's side through the bridge) serves the same requests
through each package's continuous-batching scheduler with a trace
recorder attached, for ``async_io`` in {False, True} x prefetch in {off,
request, transition}.  For each configuration:

* the port's live run equals the reference's: tokens, per-epoch miss
  counts, decode miss curve and prefetch summary exact; ledger at rtol
  1e-6 (``tests/test_golden_trace.py``'s tolerance);
* the port's recorded trace, through a file, replays in the port to its
  own live run (template: ``tests/test_sim.py``'s live fidelity gate);
  the recorder stores int32 ids while the live path charged int64;
* the reference's recorded trace replays in the port to the reference's
  live run.

Each configuration runs once per module (``runs``); the reference's
jitted prefill and decode are compiled once and shared, since the charge
path settings do not enter them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.models.moe import RoutingPolicy as JRP
from repro.serving import scheduler as JS
from repro.sim import TraceRecorder as JRecorder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.serving import scheduler as TS
from repro_torch.sim import Trace, TraceRecorder, replay_trace

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

KW = dict(cache_bytes=1.0e6, miss_rate_target=0.1, warmup="pcw",
          max_seq=24)
POLICY = dict(kind="cache_prior", slice_mode="dbsc")
CONFIGS = {
    "sync": dict(async_io=False),
    "async": dict(async_io=True),
    "sync_request": dict(async_io=False, prefetch_top_m=4,
                         prefetch_kind="request"),
    "async_request": dict(async_io=True, prefetch_top_m=4,
                          prefetch_kind="request"),
    "sync_transition": dict(async_io=False, prefetch_top_m=4,
                            prefetch_kind="transition"),
    "async_transition": dict(async_io=True, prefetch_top_m=4,
                             prefetch_kind="transition"),
}
NAMES = sorted(CONFIGS)


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
    return [rng.integers(0, vocab, 10).astype(np.int32) for _ in range(3)]


def _serve(sched_mod, engine, recorder, prompts, **sched_kw):
    sched = sched_mod.ContinuousBatchingScheduler(
        engine, sched_mod.SchedulerConfig(max_batch=2, max_queue=8),
        **sched_kw)
    rec = sched.attach_recorder(recorder)
    for i, p in enumerate(prompts):
        sched.submit(sched_mod.Request(request_id=i, prompt=p,
                                       max_new_tokens=4 + i))
    done = sched.run()
    return {
        "tokens": {c.request_id: np.asarray(c.tokens) for c in done},
        "epoch_counts": engine.cache.epoch_counts(),
        "ledger": engine.ledger.snapshot(),
        "prefetch": (engine.prefetcher.summary()
                     if engine.prefetcher is not None else None),
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "energy_curve": sched.telemetry.energy_curve(),
        "summary": sched.summary(),
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
            je = JPE(cfg, params, JEC(mat=JMat(8, 4), policy=JRP(**POLICY),
                                      **over))
            if jitted:     # the forward does not see the charge-path knobs
                je._jit_prefill, je._jit_decode = jitted["fns"]
            else:
                jitted["fns"] = je._jit_prefill, je._jit_decode
            te = TPE(tcfg, tparams, TEC(mat=TMat(8, 4), policy=TRP(**POLICY),
                                        **over), device="cpu")
            out[name] = (_serve(JS, je, JRecorder(), prompts),
                         _serve(TS, te, TraceRecorder(), prompts,
                                device="cpu"))
        return out[name]
    return get


def _assert_ledger_close(want: dict, got: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-15,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_live_engine_matches_reference(runs, name):
    j, t = runs(name)
    assert sorted(t["tokens"]) == sorted(j["tokens"]) == [0, 1, 2]
    for rid in j["tokens"]:
        np.testing.assert_array_equal(t["tokens"][rid], j["tokens"][rid])
    assert t["epoch_counts"] == j["epoch_counts"]
    assert t["miss_curve"] == j["miss_curve"]
    assert t["prefetch"] == j["prefetch"]
    assert t["summary"].get("prefetch") == j["summary"].get("prefetch")
    _assert_ledger_close(j["ledger"], t["ledger"])
    if t["prefetch"] is not None:
        p = t["prefetch"]
        assert p["issued"] > 0, p
        assert p["in_flight"] == 0
        assert p["issued"] == p["useful"] + p["late"] + p["wasted"]
        assert t["ledger"]["n_prefetch_fills"] == p["issued"]


@pytest.mark.parametrize("name", NAMES)
def test_port_live_run_replays_exactly(runs, name, tmp_path):
    _, t = runs(name)
    trace = t["trace"]
    assert trace.n_prefills == 3
    assert sorted(e.request_id for e in trace.events
                  if e.kind == "prefill") == [0, 1, 2]
    loaded = Trace.load(trace.save(str(tmp_path / "live.npz")))
    assert loaded.events[0].ids.dtype == np.int32
    rep = replay_trace(loaded)
    assert rep.miss_curve == t["miss_curve"]
    assert rep.energy_curve == t["energy_curve"]
    assert rep.epoch_counts == t["epoch_counts"]
    assert rep.prefetch == t["prefetch"]
    _assert_ledger_close(t["ledger"], rep.ledger)


@pytest.mark.parametrize("name", NAMES)
def test_reference_trace_replays_in_port(runs, name, tmp_path):
    j, _ = runs(name)
    path = j["trace"].save(str(tmp_path / "reference.jsonl"))
    rep = replay_trace(Trace.load(path))
    assert rep.miss_curve == j["miss_curve"]
    assert rep.epoch_counts == j["epoch_counts"]
    assert rep.prefetch == j["prefetch"]
    _assert_ledger_close(j["ledger"], rep.ledger)
