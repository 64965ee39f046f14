"""Port parity: BuddyMoE routing and the engine that serves with it.

* ``buddy_routing`` and ``compute_buddies``: ids and gates exact against
  the reference on seeded inputs;
* the engine under Fig. 9's ``buddy_highbit`` scheme (buddy routing,
  whole high-bit experts, empty warmup) on the 2-layer f32
  ``qwen15-moe-repro`` with one numpy tree of weights for both packages,
  with ``quant_execution`` off and on (the reference's Pallas kernel in
  interpret mode): calibrated buddies, tokens, every recorded routing id
  and per-epoch miss counts exact; logits within 1e-4; ledger at rtol
  1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core import routing as JR
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.models.moe import RoutingPolicy as JRP
from repro.sim import TraceRecorder as JRecorder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core import routing as TR
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.sim import TraceRecorder

torch.set_num_threads(1)

SCHEME = dict(fused_slices=True, warmup="empty")
KW = dict(cache_bytes=2.5e6, miss_rate_target=0.05, max_seq=40)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_buddy_routing_matches_reference(seed):
    rng = np.random.default_rng(seed)
    T, E, k = 32, 16, 4
    logits = rng.standard_normal((T, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cached = rng.random(E) < 0.4
    buddies = rng.integers(0, E, E).astype(np.int32)
    jg, ji = JR.buddy_routing(jnp.asarray(probs), jnp.asarray(cached),
                              jnp.asarray(buddies), k)
    tg, ti = TR.buddy_routing(torch.from_numpy(probs),
                              torch.from_numpy(cached),
                              torch.from_numpy(buddies).long(), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    natural = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    assert (ti.numpy() != natural).any()       # substitutions happened


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_buddies_matches_reference(dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 300)).astype(np.float32)
    w[5] = w[17] + 0.01 * w[5]                 # a clear pair
    jw = jnp.asarray(w, jnp.dtype(dtype))
    tw = params_from_numpy(np.asarray(jw), "cpu")
    want = np.asarray(JR.compute_buddies(jw))
    got = TR.compute_buddies(tw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[5] == 17 and got[17] == 5
    assert (got != np.arange(24)).all()


def test_buddy_policy_is_ported():
    ecfg = TEC(policy=TRP(kind="buddy", slice_mode="highbit"))
    assert ecfg.cache() is not None and ecfg.ledger() is not None


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


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_buddy_engine_matches_reference(model, quant_execution,
                                        monkeypatch):
    cfg, tcfg, params, tparams = model
    policy = dict(kind="buddy", slice_mode="highbit",
                  quant_execution=quant_execution)
    je = JPE(cfg, params, JEC(mat=JMat(8, 4), policy=JRP(**policy),
                              **SCHEME, **KW))
    te = TPE(tcfg, tparams, TEC(mat=TMat(8, 4), policy=TRP(**policy),
                                **SCHEME, **KW), device="cpu")
    for key, want in je.buddies.items():
        np.testing.assert_array_equal(te.buddies[key].numpy(),
                                      np.asarray(want))
    jrec, trec = JRecorder(je), TraceRecorder(te)

    subs = []                                  # port-side substitutions
    natural = TR.buddy_routing

    def counting(probs, cached, buddies, k):
        gates, ids = natural(probs, cached, buddies, k)
        subs.append(int((ids != TR.topk_routing(probs, k)[1]).sum()))
        return gates, ids

    monkeypatch.setattr(TR, "buddy_routing", counting)

    rng = np.random.default_rng(1)
    for r in range(2):
        toks = rng.integers(0, cfg.vocab_size, (1, 12))
        jl, jkv, _ = je.run_prefill(jnp.asarray(toks, jnp.int32),
                                    label=f"r{r}")
        tl, tkv, _ = te.run_prefill(toks, label=f"r{r}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        for step in range(6):
            jl, jkv, jc = je.decode_batch(jt, jkv)
            tl, tkv, tc = te.decode_batch(tt, tkv)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
            assert (tc.accesses, tc.misses) == (jc.accesses, jc.misses)
            for k in jc.ledger_delta:
                np.testing.assert_allclose(tc.ledger_delta[k],
                                           jc.ledger_delta[k], rtol=1e-6,
                                           atol=1e-15, err_msg=k)
            jt = jnp.argmax(jl, -1).astype(jnp.int32)
            tt = torch.argmax(tl, -1)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    je.cache.end_epoch()
    te.cache.end_epoch()
    assert te.cache.epoch_counts() == je.cache.epoch_counts()
    jsnap, tsnap = je.ledger.snapshot(), te.ledger.snapshot()
    for k in jsnap:
        np.testing.assert_allclose(tsnap[k], jsnap[k], rtol=1e-6,
                                   atol=1e-15, err_msg=k)
    jev, tev = jrec.trace().events, trec.trace().events
    assert [e.kind for e in tev] == [e.kind for e in jev]
    for je_, te_ in zip(jev, tev):
        np.testing.assert_array_equal(te_.ids, je_.ids)
    assert sum(subs) > 0, "no decode step substituted a buddy"
