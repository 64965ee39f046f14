"""Port parity: the expert prefetchers and the ledger's prefetch events.

``TransitionPrefetcher``, ``ActivationPredictor`` and
``RequestPrefetcher`` of both packages fed one observation sequence must
plan the same targets in the same order, with the same learned state and
outcome counters; the port's ``CostLedger`` must charge the prefetch lane
(``prefetch_fill_at``), wasted-prefetch attribution and ``clone`` as
the reference's does (templates: ``tests/test_timeline.py``,
``tests/test_prefetch_invariants.py``).  Exact: both sides run the same
numpy arithmetic in the same order.
"""

import numpy as np
import pytest

from repro.core import prefetch as JP
from repro.hw.energy import CostLedger as JLedger
from repro_torch.core import prefetch as TP
from repro_torch.hw.energy import CostLedger as TLedger

L, E = 4, 10


def _observations(seed, n_steps=5):
    """One prefill plus ``n_steps`` decode observations per layer."""
    rng = np.random.default_rng(seed)
    prefill = [(l, rng.integers(0, E, (6, 2)), rng.random((6, 2)))
               for l in range(L)]
    decode = [[(l, rng.integers(0, E, (3, 2)), rng.random((3, 2)))
               for l in range(L)] for _ in range(n_steps)]
    return prefill, decode


def _unit_bytes(key):
    return 100.0 if key.kind == "msb" else 60.0


def _resident_every(k):
    return lambda key: (key.expert + key.layer) % k == 0


def _drive_request(mod, seed, **kw):
    """Feed a RequestPrefetcher; return every plan and its final state."""
    pf = mod.RequestPrefetcher(L, E, seed=seed, **kw)
    prefill, decode = _observations(seed)
    plans = []
    for req in range(2):
        pf.begin_request(0.5 if req else 1.0)
        for layer, ids, gates in prefill:
            pf.observe_prefill(layer, ids, gates, n_tokens=ids.shape[0])
        plans.append(pf.plan_prefill(is_resident=_resident_every(3),
                                     slice_bytes=_unit_bytes))
        for step in decode:
            for layer, ids, gates in step:
                pf.observe(layer, ids, gates,
                           crit_ids=set(int(e) for e in ids[:, 0]))
                plan = pf.plan(layer, ids.reshape(-1),
                               is_resident=_resident_every(4),
                               slice_bytes=_unit_bytes,
                               pending=[k for k, _ in plans[-1][:1]],
                               lsb_allowed=True)
                plans.append(plan)
                for i, (_key, d) in enumerate(plan):
                    pf.mark_issued(distance=d)
                    (pf.mark_useful, pf.mark_late,
                     pf.mark_wasted)[i % 3](distance=d)
    return plans, pf


@pytest.mark.parametrize("kw", [
    dict(), dict(top_m=6, lookahead=3), dict(min_obs=4, min_score=0.05),
    dict(lookahead=1, lsb_crit_frac=0.2)],
    ids=["default", "top6_ahead3", "gated", "lsb_heavy"])
def test_request_prefetcher_plans_match_reference(kw):
    jplans, jpf = _drive_request(JP, 3, **kw)
    tplans, tpf = _drive_request(TP, 3, **kw)
    assert any(jplans)
    assert [[(tuple(k), d) for k, d in p] for p in tplans] == \
        [[(tuple(k), d) for k, d in p] for p in jplans]
    assert tpf.summary() == jpf.summary()
    np.testing.assert_array_equal(tpf.dist_issued, jpf.dist_issued)
    np.testing.assert_array_equal(tpf.dist_useful, jpf.dist_useful)


def test_activation_predictor_state_matches_reference():
    prefill, decode = _observations(7)
    preds = []
    for mod in (JP, TP):
        p = mod.ActivationPredictor(L, E, seed=7)
        p.begin_request(1.0)
        for layer, ids, gates in prefill:
            p.observe_prefill(layer, ids, gates, n_tokens=ids.shape[0])
        scores = []
        for step in decode:
            for layer, ids, gates in step:
                p.observe(layer, ids, gates, crit_ids=ids[:, 0])
                scores += [p.scores(layer, ids.reshape(-1), d)
                           for d in (1, 2, 3)]
        scores += [p.crit_frac(l) for l in range(L)]
        p.begin_request(0.25)
        preds.append((p, scores))
    (jp, js), (tp, ts) = preds
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(b, a)
    for name in ("act", "trans", "pfrac", "obs"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)


@pytest.mark.parametrize("min_transitions", [0, 3])
def test_transition_prefetcher_predictions_match_reference(min_transitions):
    _, decode = _observations(5, n_steps=8)
    out = []
    for mod in (JP, TP):
        tp = mod.TransitionPrefetcher(L, E, top_m=3, seed=5,
                                      min_transitions=min_transitions)
        preds = []
        for step in decode:
            prev = None
            for layer, ids, _ in step:
                if prev is not None:
                    tp.observe(layer, prev, ids)
                resident = np.arange(E) % (layer + 2) == 0
                preds.append(tp.predict(layer, ids, resident=resident))
                prev = ids
        tp.mark_issued(7)
        tp.mark_useful(3)
        tp.mark_late(1)
        tp.mark_wasted(2)
        out.append((preds, tp.summary(), tp.clone().predict(0, np.array([1]))))
    (jpred, jsum, jnext), (tpred, tsum, tnext) = out
    assert [p.tolist() for p in tpred] == [p.tolist() for p in jpred]
    assert tsum == jsum
    assert tnext.tolist() == jnext.tolist()


# --------------------------------------------------------------------------
# CostLedger: the prefetch lane, wasted attribution, clone
# --------------------------------------------------------------------------
def _ledger_events(led):
    """A mixed stream of demand, serialized and speculative events."""
    led.miss_fill(3e5)
    led.dram_read(3e5)
    led.matmul(4, 64, 256, 4)
    _, f_end = led.fill_at(led.now, 2e5)
    led.prefetch_fill_at(0.0, 1.5e5)          # waits out the demand queue
    _, r_end = led.dram_read_at(f_end, 2e5)
    led.matmul_at(r_end, 2, 64, 256, 8)
    led.prefetch_fill_at(None, 4e4)           # the serialized IO frontier
    led.miss_fill(1e5, prefetch=True)
    led.fill_at(led.now, 5e4, prefetch=True)
    led.flash_stream_at(0.0, 7e4)
    led.mark_prefetch_wasted(1.5e5)
    led.mark_prefetch_wasted(4e4)
    return led


def _assert_same_ledger(t, j):
    js, ts = j.snapshot(), t.snapshot()
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-12, atol=0.0,
                                   err_msg=k)
    assert t.flash_bg_ch.busy_until == j.flash_bg_ch.busy_until


def test_ledger_prefetch_events_match_reference():
    j = _ledger_events(JLedger())
    t = _ledger_events(TLedger())
    _assert_same_ledger(t, j)
    assert t.n_prefetch_fills == 4
    # the background lane never extends the makespan
    assert t.now == max(t.flash_ch.busy_until, t.dram_ch.busy_until,
                        t.compute_ch.busy_until)


def test_ledger_clone_is_isolated():
    t = _ledger_events(TLedger())
    fork = t.clone()
    before = t.snapshot()
    fork.prefetch_fill_at(None, 1e5)
    fork.mark_prefetch_wasted(1e5)
    assert t.snapshot() == before
    assert fork.snapshot() != before
    assert fork.flash_bg_ch is not t.flash_bg_ch


def test_ledger_clone_continues_like_reference():
    """A fork taken mid-stream goes on charging as the reference's fork
    does, and leaves the ledger it came from as it was."""
    forks = []
    for ledger in (JLedger(), TLedger()):
        led = _ledger_events(ledger)
        fork = led.clone()
        _ledger_events(fork)
        forks.append((led, fork))
    (jled, jfork), (tled, tfork) = forks
    _assert_same_ledger(tfork, jfork)
    _assert_same_ledger(tled, jled)
    assert tfork.n_prefetch_fills == 2 * tled.n_prefetch_fills
