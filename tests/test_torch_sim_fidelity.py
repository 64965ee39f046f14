"""Port parity: the sim fidelity benchmark (``benchmarks/torch_sim_fidelity``
against ``benchmarks/sim_fidelity``).

Both packages' ``_record_live`` on one numpy tree of weights (2-layer f32
``qwen15-moe-repro``, the port's CPU init), for the default, cumsum and
ep2 + async settings:

* the two live runs agree (miss and energy curves, epoch counts, the
  ledger; counts exact, floats rtol 1e-6, host walls left out);
* each package reads the other's trace file and writes it back equal
  under ``traces_equal``; the two packages' traces are equal in every
  field, the f32 gates within 1e-5 (each package sums in its own order);
* the port's replays equal its live runs through the benchmark's own
  gate functions (fidelity, cumsum, ep2, ep=1 forced sharded, the file
  round trip);
* the autotune sweep over one recorded trace gives the same rows,
  frontier and SLO winner in both packages.
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
from repro.models.moe import RoutingPolicy as JRP
from repro.sim import Trace as JTrace
from repro.sim import autotune as JAT
from repro.sim import traces_equal as j_traces_equal
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.sim import Trace as TTrace
from repro_torch.sim import replay_trace
from repro_torch.sim import traces_equal as t_traces_equal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import sim_fidelity as JSF  # noqa: E402
from benchmarks import torch_sim_fidelity as TSF  # noqa: E402

torch.set_num_threads(1)

CUMSUM = dict(kind="cumsum", slice_mode="dbsc", cumsum_tau=0.05,
              cumsum_kmax=8)
SETTINGS = {
    "default": (3, {}),
    "cumsum": (2, {"policy": CUMSUM}),
    "ep2_async": (2, {"ep_shards": 2, "async_io": True}),
}
HOST_KEYS = ("wall_s", "steps_per_s")


def test_constants_and_engine_config_are_the_references():
    assert (TSF.ARCH, TSF.PROMPT_LEN, TSF.MAX_NEW, TSF.CACHE_BYTES,
            TSF.MAX_SEQ, TSF.MISS_SLO) == \
        (JSF.ARCH, JSF.PROMPT_LEN, JSF.MAX_NEW, JSF.CACHE_BYTES,
         JSF.MAX_SEQ, JSF.MISS_SLO)
    assert dataclasses.asdict(TSF._engine_cfg()) == \
        dataclasses.asdict(JSF._engine_cfg())
    over = dict(cache_bytes=2e6, ep_shards=2, async_io=True)
    assert dataclasses.asdict(TSF._engine_cfg(**over)) == \
        dataclasses.asdict(JSF._engine_cfg(**over))
    assert TSF._engine_cfg(True).policy.quant_execution


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config(JSF.ARCH), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget(TSF.ARCH), n_layers=2, dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def recorded(model):
    """{setting: (reference (trace, live), port (trace, live))}."""
    cfg, tcfg, params, tparams = model
    out = {}
    for name, (n, over) in SETTINGS.items():
        jover = dict(over)
        tover = dict(over)
        if "policy" in over:
            jover["policy"] = JRP(**over["policy"])
            tover["policy"] = TRP(**over["policy"])
        out[name] = (JSF._record_live(cfg, params, n, **jover),
                     TSF._record_live(tcfg, tparams, n, device="cpu",
                                      **tover))
    return out


@pytest.mark.parametrize("name", list(SETTINGS))
def test_live_runs_match_reference(recorded, name):
    (_, jlive), (_, tlive) = recorded[name]
    assert set(jlive) == set(tlive)
    for k in HOST_KEYS:
        assert tlive[k] > 0
    assert_same({k: v for k, v in jlive.items() if k not in HOST_KEYS},
                {k: v for k, v in tlive.items() if k not in HOST_KEYS})


def _same_routing(a, b) -> None:
    """``a`` and ``b`` equal in meta, event order and every field, the
    f32 gates (router softmax outputs, summed in another order by each
    package) within 1e-5, a tenth of the f32 logit tolerance."""
    assert a.meta.to_dict() == b.meta.to_dict() and len(a) == len(b)
    for ea, eb in zip(a.events, b.events):
        assert ea.kind == eb.kind
        for f in dataclasses.fields(ea):
            va, vb = getattr(ea, f.name), getattr(eb, f.name)
            if f.name == "gates":
                np.testing.assert_allclose(vb, va, rtol=0.0, atol=1e-5)
            elif f.name in ea._array_fields and va is not None:
                np.testing.assert_array_equal(np.asarray(vb), np.asarray(va))
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("name", list(SETTINGS))
def test_traces_equal_and_cross_read(recorded, name, tmp_path):
    """Each package reads the other's file and writes it back unchanged
    (``traces_equal`` on both sides); the two packages' traces agree."""
    (jtrace, _), (ttrace, _) = recorded[name]
    j_in_port = TTrace.load(jtrace.save(str(tmp_path / "ref.npz")))
    t_in_ref = JTrace.load(ttrace.save(str(tmp_path / "port.jsonl")))
    assert j_traces_equal(JTrace.load(
        j_in_port.save(str(tmp_path / "ref_back.jsonl"))), jtrace)
    assert t_traces_equal(TTrace.load(
        t_in_ref.save(str(tmp_path / "port_back.npz"))), ttrace)
    _same_routing(j_in_port, ttrace)


def test_default_replay_gates(recorded, tmp_path):
    """Round trip, fidelity (a) and ep=1 forced sharded on the port's
    recorded default trace."""
    _, (trace, live) = recorded["default"]
    t_npz, t_jsonl = TSF.round_trip(trace, str(tmp_path))
    assert t_traces_equal(t_npz, t_jsonl)
    TSF.check_fidelity(replay_trace(t_npz), live)
    TSF.check_forced_ep1(t_npz, live)
    with pytest.raises(AssertionError):
        moved = dict(live, miss_curve=live["miss_curve"][:-1] + [1.0])
        TSF.check_fidelity(replay_trace(t_npz), moved)


def test_cumsum_gate(recorded):
    _, (trace, live) = recorded["cumsum"]
    pf, rep = TSF.check_cumsum(trace, live)
    assert 0.0 < float(np.asarray(pf.active).mean()) < 1.0
    assert rep.epoch_counts == live["epoch_counts"]


def test_ep2_gate(recorded):
    _, (trace, live) = recorded["ep2_async"]
    rep = TSF.check_ep2(trace, live)
    assert rep.ledger["ici_bytes"] == live["ledger"]["ici_bytes"] > 0
    assert len(rep.per_shard_epoch_counts) == 2


def test_autotune_sweep_matches_reference(recorded, tmp_path):
    """The port's sweep (the reference's policy list) over the port's
    recorded trace, against the reference's sweep over the same trace
    read into the reference: rows, frontier and SLO winner."""
    _, (trace, _) = recorded["default"]
    policies = TSF.autotune_policies()
    assert len(policies) == 11 and policies[0] == ("default(recorded)", {})
    results, default, frontier, best, wall = TSF.autotune(trace, policies)
    assert wall > 0
    jtrace = JTrace.load(trace.save(str(tmp_path / "t.npz")))
    jres = JAT.sweep(jtrace, policies, miss_slo=JSF.MISS_SLO)
    keys = ("name", "miss_rate", "energy_j", "latency_s",
            "events_consumed", "partial")
    assert_same([{k: getattr(r, k) for k in keys} for r in jres],
                [{k: getattr(r, k) for k in keys} for r in results])
    jfront = JAT.pareto_frontier(jres)
    assert [r.name for r in frontier] == [r.name for r in jfront]
    jbest = JAT.best_under_slo(jfront, JSF.MISS_SLO)
    assert (best is None) == (jbest is None)
    if best is not None:
        assert best.name == jbest.name
    assert default.name == "default(recorded)"


def test_autotune_policies_scale_every_cache_budget():
    base, scaled = TSF.autotune_policies(), TSF.autotune_policies(1000.0)
    assert [n for n, _ in base] == [n for n, _ in scaled]
    for (_, a), (_, b) in zip(base, scaled):
        assert set(a) == set(b)
        for k in a:
            want = a[k] * 1000.0 if k == "cache_bytes" else a[k]
            assert b[k] == want
