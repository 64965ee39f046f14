"""Port parity: the persistent server and the continuous-batching scheduler.

The same requests through the JAX package and the port (one numpy tree of
weights, the port's side through the bridge): tokens exact, per-request
``decode_totals`` and ``cache_stats`` at rtol 1e-6, per-epoch miss counts
exact, and the fleet summary's simulated-clock metrics equal.
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
from repro.serving.server import SliceMoEServer as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.serving import scheduler as TS
from repro_torch.serving.server import SliceMoEServer as TServer

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

KW = dict(cache_bytes=2.0e6, miss_rate_target=0.1, warmup="pcw", max_seq=40)


def _shared_params(tcfg, seed):
    """One set of weights for both packages: drawn by the port's init on the
    CPU (``jax.random`` compiles every shape on its first call, seconds per
    module), handed to JAX as arrays and to the port through the bridge."""
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    return (cfg, tcfg, *_shared_params(tcfg, seed=0))


def _requests(vocab, n, seed=0):
    """Prompts of two lengths (each length is one JAX prefill compile)."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, 9 + 3 * (i % 2)).astype(np.int32),
             3 + (i % 2)) for i in range(n)]


def _policy(qe):
    return dict(kind="cache_prior", slice_mode="dbsc", quant_execution=qe)


def _assert_completions_match(jc, tc):
    assert [c.request_id for c in tc] == [c.request_id for c in jc]
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.metrics["cache_stats"] == a.metrics["cache_stats"]
        da, db = a.metrics["decode_totals"], b.metrics["decode_totals"]
        assert set(da) == set(db)
        for k in da:
            np.testing.assert_allclose(db[k], da[k], rtol=1e-6, atol=1e-15,
                                       err_msg=k)
        for k in ("ttft_s", "queue_delay_s", "mean_miss_rate",
                  "alpha_final"):
            np.testing.assert_allclose(b.metrics[k], a.metrics[k],
                                       rtol=1e-6, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("max_batch, quant_execution", [(1, False), (2, True)],
                         ids=["1", "2"])
def test_scheduler_matches_reference(model, max_batch, quant_execution):
    """One expert path per batch size: the batched run takes the kernel
    path (the JAX side in Pallas interpret mode), the one-at-a-time run the
    dense-dequant path."""
    cfg, tcfg, params, tparams = model
    jsched = JS.ContinuousBatchingScheduler(
        JPE(cfg, params, JEC(mat=JMat(8, 4),
                             policy=JRP(**_policy(quant_execution)), **KW)),
        JS.SchedulerConfig(max_batch=max_batch))
    tsched = TS.ContinuousBatchingScheduler(
        TPE(tcfg, tparams, TEC(mat=TMat(8, 4),
                               policy=TRP(**_policy(quant_execution)), **KW),
            device="cpu"),
        TS.SchedulerConfig(max_batch=max_batch), device="cpu")
    for rid, prompt, n_new in _requests(cfg.vocab_size, 3):
        assert jsched.submit(JS.Request(rid, prompt, max_new_tokens=n_new))
        assert tsched.submit(TS.Request(rid, prompt, max_new_tokens=n_new))
    _assert_completions_match(jsched.run(), tsched.run())
    assert tsched.engine.cache.epoch_counts() == \
        jsched.engine.cache.epoch_counts()
    assert len(tsched.wall_step_s) == len(jsched.telemetry.steps)
    js_, ts_ = jsched.summary(), tsched.summary()
    for k in ("n_requests", "n_tokens", "sim_time_s", "throughput_tok_per_s",
              "ttft_p50_s", "per_token_p50_s", "mean_miss_rate",
              "steady_state_miss_rate", "mean_batch_occupancy",
              "energy_per_token_j"):
        np.testing.assert_allclose(ts_[k], js_[k], rtol=1e-6, err_msg=k)


def test_persistent_server_matches_reference(model):
    cfg, tcfg, params, tparams = model
    jserver = JServer(cfg, params, JEC(mat=JMat(8, 4),
                                       policy=JRP(**_policy(False)), **KW),
                      max_seq=KW["max_seq"])
    tserver = TServer(tcfg, tparams, TEC(mat=TMat(8, 4),
                                         policy=TRP(**_policy(False)), **KW),
                      max_seq=KW["max_seq"], device="cpu")
    for rid, prompt, n_new in _requests(cfg.vocab_size, 2, seed=1):
        jserver.submit(JS.Request(rid, prompt, max_new_tokens=n_new))
        tserver.submit(TS.Request(rid, prompt, max_new_tokens=n_new))
    _assert_completions_match(jserver.run(), tserver.run())
    assert tserver._engine.cache.epoch_counts() == \
        jserver._engine.cache.epoch_counts()


def test_admission_rejects_like_reference(model):
    cfg, tcfg, params, tparams = model
    tsched = TS.ContinuousBatchingScheduler(
        TPE(tcfg, tparams, TEC(mat=TMat(8, 4), policy=TRP(**_policy(False)),
                               **KW), device="cpu"),
        TS.SchedulerConfig(max_batch=1, max_queue=1), device="cpu")
    jsched = JS.ContinuousBatchingScheduler(
        JPE(cfg, params, JEC(mat=JMat(8, 4), policy=JRP(**_policy(False)),
                             **KW)),
        JS.SchedulerConfig(max_batch=1, max_queue=1))
    cases = [(0, np.zeros(30, np.int32), 20),     # over the KV budget
             (1, np.zeros(5, np.int32), 3),       # fits
             (2, np.zeros(5, np.int32), 3)]       # queue full
    for rid, prompt, n_new in cases:
        assert tsched.submit(TS.Request(rid, prompt, max_new_tokens=n_new)) \
            == jsched.submit(JS.Request(rid, prompt, max_new_tokens=n_new))
    assert tsched.telemetry.rejected == jsched.telemetry.rejected == [0, 2]


def test_scheduler_refuses_a_device_other_than_the_engines(model):
    _, tcfg, _, tparams = model
    eng = TPE(tcfg, tparams, TEC(mat=TMat(8, 4), **KW), device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        TS.ContinuousBatchingScheduler(eng, device="cuda")
