"""Port parity: the serving-load benchmark's cells (``benchmarks/
torch_serving_load`` against ``benchmarks/serving_load``).

On one numpy tree of weights (2-layer f32 ``qwen15-moe-repro``, the
port's CPU init), at 2-3 requests a cell: ``run_cell`` under each
section's settings (the rate x batch sweep, serialized / async / async +
markov, the request predictor and plain async on tenant-mix traffic, ep 2
and 4, hotness placement with and without replicas) gives equal
schedulers' summaries (counts exact, floats rtol 1e-6, the host-wall
keys left out), ledgers, epoch counts, prefetch summaries and
migrations; so do ``run_cold_baseline`` and ``_epoch_miss_rate``.  The
sections' own checks are in ``test_torch_serving_sections.py``, the
calibrated claims in ``test_torch_serving_claims.py``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.configs.base import get_config
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import serving_load as JSL  # noqa: E402
from benchmarks import torch_serving_load as TSL  # noqa: E402

torch.set_num_threads(1)

WALL_KEYS = ("wall_s", "wall_tok_per_s")
TMIX = "tenant_mix"                     # requests from _tenant_mix_workload
CELLS = {
    "sweep_poisson@2_b2": dict(max_batch=2, n_requests=3, kind="poisson",
                               rate=2.0),
    "sweep_saturated_b2": dict(max_batch=2, n_requests=3),
    "timeline_serialized_b4": dict(max_batch=4, n_requests=3),
    "timeline_async_b4": dict(max_batch=4, n_requests=3, async_io=True),
    "timeline_markov_b4": dict(max_batch=4, n_requests=3, async_io=True,
                               prefetch_top_m=4,
                               prefetch_kind="transition"),
    "request_plain_async": dict(max_batch=4, n_requests=3, requests=TMIX,
                                warmup="empty", async_io=True),
    "request_predictor": dict(max_batch=4, n_requests=3, requests=TMIX,
                              warmup="empty", async_io=True,
                              **TSL.PF_KNOBS),
    "ep2": dict(max_batch=4, n_requests=3, async_io=True, ep_shards=2),
    "ep4": dict(max_batch=4, n_requests=3, async_io=True, ep_shards=4),
    "placement_hotness": dict(max_batch=4, n_requests=3, async_io=True,
                              ep_shards=4, placement="hotness",
                              placement_period=4,
                              cache_bytes=TSL.PLACE_CACHE),
    "placement_replicate": dict(max_batch=4, n_requests=3, async_io=True,
                                ep_shards=4,
                                placement="hotness+replicate:2",
                                placement_period=4,
                                cache_bytes=TSL.PLACE_CACHE),
}


def test_constants_and_engine_config_are_the_references():
    assert (TSL.ARCH, TSL.PROMPT_LEN, TSL.MAX_NEW, TSL.CACHE_BYTES,
            TSL.MAX_SEQ) == (JSL.ARCH, JSL.PROMPT_LEN, JSL.MAX_NEW,
                             JSL.CACHE_BYTES, JSL.MAX_SEQ)
    for kw in ({}, dict(async_io=True, prefetch_top_m=4, ep_shards=2),
               dict(warmup="empty", placement="hotness",
                    placement_period=8, cache_bytes=0.8e6,
                    prefetch_kind="request", prefetch_lookahead=3,
                    prefetch_min_obs=4, prefetch_min_score=0.18)):
        for qe in (False, True):
            assert dataclasses.asdict(TSL._engine_cfg(qe, **kw)) == \
                dataclasses.asdict(JSL._engine_cfg(qe, **kw))


def _requests_view(reqs):
    return [(r.request_id, np.asarray(r.prompt).tolist(), r.max_new_tokens,
             r.arrival_time, r.tenant) for r in reqs]


@pytest.mark.parametrize("kind,rate", [("closed_loop", 2.0),
                                       ("poisson", 20.0)])
def test_workloads_are_the_references(kind, rate):
    assert _requests_view(TSL._workload(5, 0, kind=kind, rate=rate)) == \
        _requests_view(JSL._workload(5, 0, kind=kind, rate=rate))
    assert _requests_view(TSL._tenant_mix_workload(6, 1, max_new=24)) == \
        _requests_view(JSL._tenant_mix_workload(6, 1, max_new=24))
    wide = TSL._workload(3, 0, vocab_size=151936)
    assert max(int(np.max(r.prompt)) for r in wide) >= 2048


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config(JSL.ARCH), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget(TSL.ARCH), n_layers=2, dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _both(model, **kw):
    """``run_cell`` of each package with ``kw``: ((summary, engine) of the
    reference, (summary, engine) of the port)."""
    cfg, tcfg, params, tparams = model
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("requests") == TMIX:
        n = kw["n_requests"]
        jkw["requests"] = JSL._tenant_mix_workload(n, seed=TSL.PF_SEED,
                                                   max_new=12)
        tkw["requests"] = TSL._tenant_mix_workload(n, seed=TSL.PF_SEED,
                                                   max_new=12)
    return (JSL.run_cell(cfg, params, **jkw),
            TSL.run_cell(tcfg, tparams, device="cpu", **tkw))


def _summary(s):
    return {k: v for k, v in s.items() if k not in WALL_KEYS}


@pytest.mark.parametrize("name", list(CELLS))
def test_run_cell_matches_reference(model, name):
    (js, je), (ts, te) = _both(model, **CELLS[name])
    for k in WALL_KEYS:
        assert k in ts and k in js
    assert_same(_summary(js), _summary(ts))
    assert_same(je.ledger.snapshot(), te.ledger.snapshot())
    assert te.cache.epoch_counts() == je.cache.epoch_counts()
    assert (te.prefetcher is None) == (je.prefetcher is None)
    if te.prefetcher is not None:
        assert_same(je.prefetcher.summary(), te.prefetcher.summary())
        assert_same(je.ledger.prefetch_wasted_energy_j,
                    te.ledger.prefetch_wasted_energy_j)
    assert_same(je.migration_events, te.migration_events)


def test_cold_baseline_and_epoch_miss_rate_match_reference(model):
    cfg, tcfg, params, tparams = model
    jcold = JSL.run_cold_baseline(cfg, params, n_requests=2)
    tcold = TSL.run_cold_baseline(tcfg, tparams, n_requests=2, device="cpu")
    assert_same(jcold, tcold)
    assert tcold["n_tokens"] == 2 * TSL.MAX_NEW
    (_, je), (_, te) = _both(model, max_batch=1, n_requests=3)
    for skip in (0, 1, 2):
        assert_same(JSL._epoch_miss_rate(je.cache, skip),
                    TSL._epoch_miss_rate(te.cache, skip))
    assert TSL._epoch_miss_rate(te.cache, 99) == 0.0
