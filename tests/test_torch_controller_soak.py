"""Port parity: the SLO-controller soak (``benchmarks/torch_controller_soak``
against ``benchmarks/controller_soak``).

* the SLO grid, the static configs and the controller config are the
  reference's;
* the model-free soak grid equals the reference's persisted
  ``results/BENCH_controller_soak.json`` at rtol 1e-6 and the reference's
  own replay of the same trace (counts exact, floats rtol 1e-6), and
  gates (a) and (c) hold;
* ``_live_fidelity`` at its quick size in both packages on one numpy tree
  (2-layer f32 ``qwen15-moe-repro``): controller levels, budgets,
  ``n_actions`` and epoch counts exact, energies at rtol 1e-6.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as JCB
import repro.core.engine as JENG
import repro.models.model as JMM
from _torch_parity import assert_same
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import controller_soak as JCS  # noqa: E402
from benchmarks import torch_controller_soak as TCS  # noqa: E402

torch.set_num_threads(1)

PERSISTED = os.path.join(os.path.dirname(__file__), "..", "results",
                         "BENCH_controller_soak.json")
CONFIG_NAMES = ["static:dbsc", "static:lowbit", "static:highbit",
                "controller"]


def test_slos_statics_and_controller_config_are_the_references():
    assert {t: s.to_dict() for t, s in TCS.SLOS.items()} == \
        {t: s.to_dict() for t, s in JCS.SLOS.items()}
    assert TCS.STATICS == JCS.STATICS
    for interval in (2, 4):
        for partition in (False, True):
            t = TCS._controller_cfg(interval, partition=partition)
            j = JCS._controller_cfg(interval, partition=partition)
            assert {k: v for k, v in vars(t).items() if k != "slos"} == \
                {k: v for k, v in vars(j).items() if k != "slos"}
            assert {n: s.to_dict() for n, s in t.slos.items()} == \
                {n: s.to_dict() for n, s in j.slos.items()}


@pytest.fixture(scope="module")
def soak_full():
    return TCS.soak(quick=False)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_full_soak_grid_equals_the_persisted_reference_file(soak_full,
                                                            name):
    trace, results, _ = soak_full
    with open(PERSISTED) as f:
        prev = json.load(f)
    assert prev["n_decode_steps"] == trace.n_decode_steps == 576
    assert prev["n_requests"] == trace.n_prefills
    row = results[name]
    for k in ("attainment", "energy_j", "latency_s", "decode_miss_rate"):
        np.testing.assert_allclose(row[k], prev["configs"][name][k],
                                   rtol=1e-6, atol=0.0, err_msg=k)
    assert_same(prev["configs"][name]["grid"], row["grid"])
    assert row["n_cells"] == prev["configs"][name]["n_cells"]


def test_full_soak_gates_and_baseline_check(soak_full):
    """Gate (a) on the full grid ((c) is asserted inside ``soak``), the
    best static the persisted one, and the port's baseline check against
    the reference's file passing."""
    trace, results, ctl_rep = soak_full
    ctl = results["controller"]
    for name in TCS.STATICS:
        assert ctl["attainment"] > results[name]["attainment"]
    best = TCS.best_static(results)
    assert ctl["energy_j"] <= results[best]["energy_j"]
    with open(PERSISTED) as f:
        prev = json.load(f)
    assert best == prev["best_static"]
    assert ctl_rep.controller_summary["n_actions"] == \
        prev["controller_actions"]
    TCS._check_against_baseline(
        {"n_decode_steps": trace.n_decode_steps, "configs": results},
        quick=False)
    with pytest.raises(AssertionError, match="persisted baseline"):
        moved = {n: dict(r) for n, r in results.items()}
        moved["controller"]["energy_j"] *= 1.001
        TCS._check_against_baseline(
            {"n_decode_steps": trace.n_decode_steps, "configs": moved},
            quick=False)


@pytest.mark.parametrize("quick", [True, False])
def test_soak_equals_the_references_replay(quick):
    """The reference's trace and scores, computed now, against the
    port's: the traces' routing, every score and the controller's
    summary."""
    jtrace = JCS._soak_trace(quick)
    jres = {name: JCS.score(jtrace, JCS.replay_trace(jtrace, **ov))
            for name, ov in JCS.STATICS.items()}
    jctl = JCS.replay_trace(jtrace, controller=JCS._controller_cfg())
    jres["controller"] = JCS.score(jtrace, jctl)
    trace, results, ctl_rep = TCS.soak(quick)
    assert len(trace.events) == len(jtrace.events)
    for a, b in zip(trace.events, jtrace.events):
        assert a.kind == b.kind
        np.testing.assert_array_equal(a.ids, b.ids)
    assert_same(jres, results)
    assert_same(jctl.controller_summary, ctl_rep.controller_summary)
    assert TCS._step_cells(trace) == JCS._step_cells(jtrace)


@pytest.fixture(scope="module")
def tree():
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    return jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))


def _capture(monkeypatch, module):
    """Subclass ``module.PersistentEngine`` so the engines built while the
    patch holds are kept."""
    built = []

    class Kept(module.PersistentEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(module, "PersistentEngine", Kept)
    return built


def test_live_fidelity_matches_reference(tree, monkeypatch):
    """Both packages' ``_live_fidelity(quick=True)`` on one f32 numpy
    tree: the reference's gets it through its own ``init_params`` and
    ``get_config`` (patched for the call), the port's as arguments."""
    jcfg = dataclasses.replace(JCB.get_config("qwen15-moe-repro"),
                               dtype="float32")
    monkeypatch.setattr(JCB, "get_config", lambda name: jcfg)
    monkeypatch.setattr(JMM, "init_params",
                        lambda cfg, key: jax.tree.map(jnp.asarray, tree))
    jbuilt = _capture(monkeypatch, JENG)
    tbuilt = _capture(monkeypatch, TCS)
    jout = JCS._live_fidelity(True)
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tout = TCS._live_fidelity(True, cfg=tcfg,
                              params=params_from_numpy(tree, "cpu"),
                              device="cpu")
    assert tout == jout
    (je,), (te,) = jbuilt, tbuilt
    assert te.cache.epoch_counts() == je.cache.epoch_counts()
    jc, tc = je.slo_controller.summary(), te.slo_controller.summary()
    for k in ("levels", "budgets", "n_actions"):
        assert tc[k] == jc[k], k
    assert_same(je.ledger.snapshot(), te.ledger.snapshot())
    assert tout["n_steps"] == 4 * 12 and tout["n_actions"] > 0


def test_live_fidelity_with_quantized_execution(tree, monkeypatch):
    """``quant_execution=True`` puts the policy on the packed codes (the
    kernels' plain versions on the CPU); gate (b) holds there too."""
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    built = _capture(monkeypatch, TCS)
    out = TCS._live_fidelity(True, cfg=tcfg,
                             params=params_from_numpy(tree, "cpu"),
                             device="cpu", quant_execution=True)
    assert [e.ecfg.policy.quant_execution for e in built] == [True]
    assert out["n_steps"] == 4 * 12
