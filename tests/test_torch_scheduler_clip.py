"""Port parity: prompt clipping and bucketing in the continuous-batching
scheduler (``SchedulerConfig.truncate_prompts`` / ``bucket_prompts``,
``ContinuousBatchingScheduler._clip_prompt``).

The first two tests are the port's counterparts of
``tests/test_serving.py``'s ``test_long_prompt_rejected_by_full_token_budget``
and ``test_truncate_prompts_opt_in`` (the 2-layer ``qwen15-moe-repro`` at
the port's init).  The rest serve one request mix through both packages
on one numpy tree at f32 (the port's side through the bridge), under
each clipping setting: which requests are admitted, the clipped prompt
lengths (read from the recorded prefill events), the ``truncated`` flags
and the tokens are exact; epoch counts exact, the ledger at rtol 1e-6.
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
from repro_torch.sim import TraceRecorder

torch.set_num_threads(1)

MAX_SEQ, MAX_NEW = 64, 8
# Prompt lengths of the mix: one over the KV budget (64 - 8 - 1 = 55),
# one on a multiple of 8, two off it, one shorter than a bucket.
LENGTHS = (60, 24, 13, 30, 5)


def _ecfg(EC, Mat, RP, **over):
    kw = dict(mat=Mat(8, 4), cache_bytes=2.5e6,
              policy=RP(kind="cache_prior", slice_mode="dbsc"),
              miss_rate_target=0.1, warmup="pcw", max_seq=MAX_SEQ)
    kw.update(over)
    return EC(**kw)


@pytest.fixture(scope="module")
def port_bf16():
    cfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2)
    return cfg, TM.init_params(cfg, seed=0, device="cpu")


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


def test_long_prompt_rejected_by_full_token_budget(port_bf16):
    """Admission gates on the full budget (prompt + new tokens) against
    max_seq, not on max_new_tokens alone."""
    cfg, params = port_bf16
    engine = TPE(cfg, params, _ecfg(TEC, TMat, TRP), device="cpu")
    sched = TS.ContinuousBatchingScheduler(
        engine, TS.SchedulerConfig(max_batch=1, max_queue=8), device="cpu")
    long_prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 60).astype(np.int32)
    bad = TS.Request(request_id=0, prompt=long_prompt, max_new_tokens=8)
    assert not sched.servable(bad)
    assert not sched.submit(bad)
    ok = TS.Request(request_id=1, prompt=long_prompt[:50],
                    max_new_tokens=8)                     # 50+8+1 <= 64
    assert sched.submit(ok)
    done = sched.run()
    assert [c.request_id for c in done] == [1]
    assert len(done[0].tokens) == 8
    assert not done[0].metrics["prompt_truncated"]
    assert int(sched.batch_cache["pos"].max()) <= engine.ecfg.max_seq


def test_truncate_prompts_opt_in(port_bf16):
    """With ``truncate_prompts`` the same long prompt is admitted,
    clipped to the KV budget (tail kept) and flagged."""
    cfg, params = port_bf16
    engine = TPE(cfg, params, _ecfg(TEC, TMat, TRP), device="cpu")
    sched = TS.ContinuousBatchingScheduler(
        engine, TS.SchedulerConfig(max_batch=1, max_queue=8,
                                   truncate_prompts=True), device="cpu")
    rec = sched.attach_recorder(TraceRecorder())
    long_prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 60).astype(np.int32)
    req = TS.Request(request_id=0, prompt=long_prompt, max_new_tokens=8)
    assert sched.submit(req)
    done = sched.run()
    assert len(done) == 1 and len(done[0].tokens) == 8
    assert done[0].metrics["prompt_truncated"]
    assert sched.telemetry.requests[0].truncated
    assert rec.trace().events[0].ids.shape[2] == MAX_SEQ - 8 - 1
    assert int(sched.batch_cache["pos"].max()) <= engine.ecfg.max_seq


def test_clip_keeps_the_tail_and_rejects_a_budget_without_room(port_bf16):
    cfg, params = port_bf16
    engine = TPE(cfg, params, _ecfg(TEC, TMat, TRP), device="cpu")
    sched = TS.ContinuousBatchingScheduler(
        engine, TS.SchedulerConfig(bucket_prompts=8, truncate_prompts=True),
        device="cpu")
    prompt = np.arange(60, dtype=np.int32)
    req = TS.Request(request_id=3, prompt=prompt, max_new_tokens=MAX_NEW)
    assert sched.submit(req)
    clipped = sched._clip_prompt(req)
    # 55 tokens fit the budget; the bucket rounds them down to 48.
    np.testing.assert_array_equal(clipped, prompt[-48:])
    assert sched.telemetry.requests[3].truncated
    full = TS.Request(request_id=4, prompt=np.arange(16, dtype=np.int32),
                      max_new_tokens=MAX_NEW)
    assert sched.submit(full)
    np.testing.assert_array_equal(sched._clip_prompt(full), full.prompt)
    assert not sched.telemetry.requests[4].truncated
    # A decode budget that leaves no prompt room is refused at
    # admission; the clip raises rather than admit an empty prompt.
    tight = TS.Request(request_id=5, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=MAX_SEQ - 1)
    assert not sched.submit(tight)
    with pytest.raises(ValueError, match="leaves no room"):
        sched._clip_prompt(tight)


def _serve(S, engine, rec, vocab, sched_cfg, **kw):
    sched = S.ContinuousBatchingScheduler(engine, sched_cfg, **kw)
    sched.attach_recorder(rec)
    rng = np.random.default_rng(5)
    accepted = []
    for rid, n in enumerate(LENGTHS):
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        accepted.append(sched.submit(S.Request(
            request_id=rid, prompt=prompt, max_new_tokens=MAX_NEW)))
    done = sched.run()
    trace = rec.trace()
    return {
        "accepted": accepted,
        "clipped": {e.request_id: int(e.ids.shape[2])
                    for e in trace.events if e.kind == "prefill"},
        "truncated": {rid: r.truncated
                      for rid, r in sched.telemetry.requests.items()},
        "flagged": {c.request_id: c.metrics["prompt_truncated"]
                    for c in done},
        "tokens": {c.request_id: np.asarray(c.tokens).tolist()
                   for c in done},
        "routing": [np.asarray(e.ids).tolist() for e in trace.events],
        "epoch_counts": engine.cache.epoch_counts(),
        "ledger": engine.ledger.snapshot(),
    }


@pytest.mark.parametrize("bucket, truncate, max_batch", [
    (0, True, 2), (8, False, 2), (8, True, 2), (8, True, 1)])
def test_clipping_and_bucketing_match_reference(model, bucket, truncate,
                                                max_batch):
    cfg, tcfg, params, tparams = model
    sc = dict(max_batch=max_batch, max_queue=8, bucket_prompts=bucket,
              truncate_prompts=truncate)
    ref = _serve(JS, JPE(cfg, params, _ecfg(JEC, JMat, JRP)), JRecorder(),
                 cfg.vocab_size, JS.SchedulerConfig(**sc))
    port = _serve(TS, TPE(tcfg, tparams, _ecfg(TEC, TMat, TRP),
                          device="cpu"), TraceRecorder(), tcfg.vocab_size,
                  TS.SchedulerConfig(**sc), device="cpu")
    assert_same(ref, port)
    budget = MAX_SEQ - MAX_NEW - 1
    want = {}
    for rid, n in enumerate(LENGTHS):
        if n > budget and not truncate:
            continue
        m = min(n, budget)
        want[rid] = (m // bucket) * bucket if bucket > 1 and m > bucket \
            else m
    assert port["clipped"] == want
    assert port["flagged"] == {rid: want[rid] != LENGTHS[rid]
                               for rid in want}
    assert port["accepted"] == [rid in want for rid in range(len(LENGTHS))]
