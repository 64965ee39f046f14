"""Port parity: the single-batch server's cold and plain-engine paths
(``SliceMoEServer(persistent=False)``, ``SliceMoEServer(engine_cfg=None)``,
``PlainEngine``) and the ``attach_*`` hooks' refusals.

The 2-layer ``qwen15-moe-repro`` at f32, one numpy tree for both
packages (the port's side through the bridge): the cold path's tokens
exact and its ``decode_totals`` at rtol 1e-6 (``cache_stats`` exact),
``eos`` clipping, the plain engine's tokens exact, and the reference's
``ValueError`` messages.  Then the port's counterparts of
``tests/test_system.py::TestServing::test_server_moe_arch`` and
``tests/test_serving.py::TestWarmCache::test_fresh_engines_stay_cold``.
``test_server_dense_arch`` (``smollm-360m``) is in
``tests/test_torch_archs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.models.moe import RoutingPolicy as JRP
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import TimelineTracer as JTracer
from repro.serving import server as JSV
from repro.sim import TraceRecorder as JRecorder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.obs import MetricsRegistry as TMetrics
from repro_torch.obs import TimelineTracer as TTracer
from repro_torch.serving import scheduler as TS
from repro_torch.serving import server as TSV
from repro_torch.sim import TraceRecorder

torch.set_num_threads(1)

MAX_SEQ = 64


def _ecfg(EC, Mat, RP, **over):
    kw = dict(mat=Mat(8, 4), cache_bytes=1.0e6,
              policy=RP(kind="cache_prior", slice_mode="dbsc"),
              miss_rate_target=0.1, warmup="pcw")
    kw.update(over)
    return EC(**kw)


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


def _prompts(vocab, n=2, length=12):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, length).astype(np.int32)
            for _ in range(n)]


def _serve(SV, cfg, params, engine_cfg, prompts, *, max_new=5, eos=None,
           **kw):
    server = SV.SliceMoEServer(cfg, params, engine_cfg=engine_cfg,
                               max_seq=MAX_SEQ, persistent=False, **kw)
    for i, p in enumerate(prompts):
        server.submit(SV.Request(request_id=i, prompt=p,
                                 max_new_tokens=max_new,
                                 eos_token=None if eos is None else eos[i]))
    return server.run()


def _view(done):
    out = []
    for c in done:
        row = {"id": c.request_id, "tokens": np.asarray(c.tokens).tolist(),
               "dtype": str(np.asarray(c.tokens).dtype)}
        if c.metrics is not None:
            row["decode_totals"] = c.metrics["decode_totals"]
            row["cache_stats"] = c.metrics["cache_stats"]
            row["per_step"] = c.metrics["per_step"]
        out.append(row)
    return out


@pytest.fixture(scope="module")
def cold(model):
    cfg, tcfg, params, tparams = model
    prompts = _prompts(cfg.vocab_size)
    ref = _serve(JSV, cfg, params, _ecfg(JEC, JMat, JRP), prompts)
    port = _serve(TSV, tcfg, tparams, _ecfg(TEC, TMat, TRP), prompts,
                  device="cpu")
    return prompts, ref, port


def test_cold_path_matches_reference(cold):
    _, ref, port = cold
    assert [len(c.tokens) for c in port] == [5, 5]
    assert all(c.metrics["logits_finite"] for c in port)
    assert all(c.prefill_s > 0 and c.decode_s > 0 for c in port)
    assert_same(_view(ref), _view(port))


def test_cold_path_clips_at_eos(model, cold):
    cfg, tcfg, params, tparams = model
    prompts, _, port = cold
    # Stop request 0 at its third token and request 1 at its first.
    eos = [int(port[0].tokens[2]), int(port[1].tokens[0])]
    ref = _serve(JSV, cfg, params, _ecfg(JEC, JMat, JRP), prompts, eos=eos)
    got = _serve(TSV, tcfg, tparams, _ecfg(TEC, TMat, TRP), prompts,
                 eos=eos, device="cpu")
    assert [len(c.tokens) for c in got] == [
        list(port[0].tokens).index(eos[0]) + 1, 1]
    assert [c.tokens[-1] for c in got] == eos
    assert_same(_view(ref), _view(got))


@pytest.mark.parametrize("eos", [False, True], ids=["full", "eos"])
def test_plain_engine_matches_reference(model, eos):
    cfg, tcfg, params, tparams = model
    prompts = _prompts(cfg.vocab_size)
    port = _serve(TSV, tcfg, tparams, None, prompts, device="cpu")
    stops = None
    if eos:
        stops = [int(port[0].tokens[1]), int(port[1].tokens[3])]
        port = _serve(TSV, tcfg, tparams, None, prompts, eos=stops,
                      device="cpu")
    ref = _serve(JSV, cfg, params, None, prompts, eos=stops)
    assert all(c.metrics is None for c in port)
    assert_same(_view(ref), _view(port))
    if not eos:
        assert [len(c.tokens) for c in port] == [5, 5]


def test_plain_engine_is_the_float_model(model):
    """``PlainEngine`` runs the model's own prefill and greedy decode."""
    _, tcfg, _, tparams = model
    prompt = _prompts(tcfg.vocab_size, n=1)[0]
    got, metrics = TSV.PlainEngine(tcfg, tparams, MAX_SEQ,
                                   device="cpu").generate(prompt, 4)
    logits, cache, _ = TM.prefill(tparams, tcfg,
                                  torch.as_tensor(prompt)[None], MAX_SEQ)
    want = []
    token = torch.argmax(logits, dim=-1)
    for _ in range(4):
        want.append(int(token[0]))
        logits, cache, _ = TM.decode_step(tparams, tcfg, token, cache)
        token = torch.argmax(logits, dim=-1)
    assert metrics is None and got.dtype == np.int32
    assert got.tolist() == want


@pytest.mark.parametrize("setting", ["cold", "plain"])
@pytest.mark.parametrize("hook", ["attach_tracer", "attach_metrics",
                                  "attach_recorder"])
def test_attach_hooks_refuse_outside_persistent_moe(model, setting, hook):
    cfg, tcfg, params, tparams = model
    persistent = setting == "plain"
    args = {"attach_tracer": (JTracer, TTracer),
            "attach_metrics": (JMetrics, TMetrics),
            "attach_recorder": (JRecorder, TraceRecorder)}[hook]
    msgs = []
    for SV, c, p, ecfg, arg in (
            (JSV, cfg, params, _ecfg(JEC, JMat, JRP), args[0]),
            (TSV, tcfg, tparams, _ecfg(TEC, TMat, TRP), args[1])):
        kw = {} if SV is JSV else {"device": "cpu"}
        server = SV.SliceMoEServer(
            c, p, engine_cfg=None if setting == "plain" else ecfg,
            max_seq=MAX_SEQ, persistent=persistent, **kw)
        with pytest.raises(ValueError) as err:
            getattr(server, hook)(arg())
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "requires persistent MoE serving" in msgs[1]


def test_cold_requests_never_share_an_engine(model, monkeypatch):
    """Each cold request builds its own engine, and the last one is
    unreachable before the next is built."""
    import gc
    import weakref

    _, tcfg, _, tparams = model
    built = []

    class Tracked(TSV.SliceMoEEngine):
        def __init__(self, *a, **kw):
            gc.collect()
            built.append(sum(r() is not None for r in refs))
            super().__init__(*a, **kw)
            refs.append(weakref.ref(self))

    refs = []
    monkeypatch.setattr(TSV, "SliceMoEEngine", Tracked)
    done = _serve(TSV, tcfg, tparams, _ecfg(TEC, TMat, TRP),
                  _prompts(tcfg.vocab_size, n=3), max_new=2, device="cpu")
    assert len(done) == 3 and len(refs) == 3
    assert built == [0, 0, 0]


@pytest.mark.parametrize("persistent", [True, False],
                         ids=["persistent", "cold"])
def test_server_moe_arch(persistent):
    """The counterpart of ``test_system.py::TestServing::
    test_server_moe_arch`` (the port's init), on both paths."""
    cfg = dataclasses.replace(tget("deepseek-v2-lite-repro"), n_layers=2)
    params = TM.init_params(cfg, seed=0, device="cpu")
    server = TSV.SliceMoEServer(
        cfg, params,
        engine_cfg=TEC(mat=TMat(8, 4), cache_bytes=1e6,
                       policy=TRP(kind="cache_prior"),
                       miss_rate_target=0.1),
        max_seq=64, persistent=persistent, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        server.submit(TSV.Request(
            request_id=i,
            prompt=rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
            max_new_tokens=8))
    done = server.run()
    assert len(done) == 2
    for c in done:
        assert len(c.tokens) == 8
        assert c.metrics is not None
        assert c.metrics["decode_totals"]["total_energy_j"] > 0


def test_fresh_engines_stay_cold(model, monkeypatch):
    """The counterpart of ``test_serving.py::TestWarmCache::
    test_fresh_engines_stay_cold``: a fresh engine per request, so every
    prefill misses 100%, through the scheduler and through the server's
    cold path."""
    _, tcfg, _, tparams = model
    ecfg = _ecfg(TEC, TMat, TRP, cache_bytes=2.5e6, max_seq=MAX_SEQ)
    prompt = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, 16).astype(np.int32)
    for _ in range(2):
        engine = TPE(tcfg, tparams, ecfg, device="cpu")
        sched = TS.ContinuousBatchingScheduler(
            engine, TS.SchedulerConfig(max_batch=1, max_queue=2),
            device="cpu")
        sched.submit(TS.Request(request_id=0, prompt=prompt.copy(),
                                max_new_tokens=2))
        sched.run()
        rates = dict(engine.cache.epoch_miss_rates())
        assert rates["req0/prefill"] == 1.0

    prefill_miss = []

    class Probe(TSV.SliceMoEEngine):
        def _finish_prefill(self, label):
            # The prompt's counters, read before the decode window opens.
            prefill_miss.append(self.cache.stats.miss_rate)
            return super()._finish_prefill(label)

    monkeypatch.setattr(TSV, "SliceMoEEngine", Probe)
    done = _serve(TSV, tcfg, tparams, ecfg, [prompt, prompt.copy()],
                  max_new=2, device="cpu")
    assert len(done) == 2 and prefill_miss == [1.0, 1.0]
