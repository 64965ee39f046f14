"""Port parity: the golden-trace regression gate, through the port's own
replay (``repro_torch.sim``, no JAX).

``tests/data/golden_trace.npz`` is a committed synthetic routing trace;
``tests/data/golden_expected.json`` holds the replay observables for
three pinned engine configurations (plain demand path, request-level
prefetch, Markov-transition prefetch).  Any charge-path change that
moves these numbers fails here *loudly* — per-epoch miss **counts**
must match exactly (integer fidelity: rates can agree by coincidence
while the counts differ), energy/latency at rtol 1e-6, and prefetch
outcome counters exactly.

Intentional changes regenerate the fixture:

    PYTHONPATH=src python tests/data/regen_golden.py

and commit both files with the explanation.  The cases and tolerances
are those of ``tests/test_golden_trace.py``, which holds the reference to
the same file.
"""

import json
import pathlib

import numpy as np
import pytest

from repro_torch.sim import Trace, replay_trace

DATA = pathlib.Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def golden():
    trace = Trace.load(str(DATA / "golden_trace.npz"))
    expected = json.loads((DATA / "golden_expected.json").read_text())
    return trace, expected


@pytest.fixture(scope="module")
def reports(golden):
    """Replay each pinned config once; every test compares against its
    slice of the expectations."""
    trace, expected = golden
    return {name: replay_trace(trace, **row["overrides"])
            for name, row in expected["configs"].items()}


def test_golden_trace_shape(golden):
    trace, expected = golden
    kw = expected["trace_kw"]
    assert trace.n_prefills == kw["n_requests"]
    assert trace.n_decode_steps == kw["n_requests"] * kw["decode_steps"]
    assert trace.meta.n_moe_layers == 3
    assert trace.meta.n_experts == 12


@pytest.mark.parametrize("name", ["baseline", "request_prefetch",
                                  "transition_prefetch"])
def test_golden_epoch_miss_counts_exact(reports, golden, name):
    _trace, expected = golden
    want = [(label, a, m)
            for label, a, m in expected["configs"][name]["epoch_counts"]]
    assert reports[name].epoch_counts == want


@pytest.mark.parametrize("name", ["baseline", "request_prefetch",
                                  "transition_prefetch"])
def test_golden_decode_totals_exact(reports, golden, name):
    _trace, expected = golden
    row = expected["configs"][name]
    rep = reports[name]
    assert rep.decode_accesses == row["decode_accesses"]
    assert rep.decode_misses == row["decode_misses"]


@pytest.mark.parametrize("name", ["baseline", "request_prefetch",
                                  "transition_prefetch"])
def test_golden_energy_latency_rtol(reports, golden, name):
    _trace, expected = golden
    row = expected["configs"][name]
    rep = reports[name]
    np.testing.assert_allclose(rep.total_energy_j, row["total_energy_j"],
                               rtol=1e-6)
    np.testing.assert_allclose(rep.total_latency_s,
                               row["total_latency_s"], rtol=1e-6)
    for key, want in row["ledger"].items():
        np.testing.assert_allclose(rep.ledger[key], want, rtol=1e-6,
                                   err_msg=f"ledger[{key}]")


@pytest.mark.parametrize("name", ["request_prefetch",
                                  "transition_prefetch"])
def test_golden_prefetch_outcomes_exact(reports, golden, name):
    _trace, expected = golden
    want = expected["configs"][name]["prefetch"]
    got = reports[name].prefetch
    assert {k: got[k] for k in want} == want
    assert got["in_flight"] == 0
    assert got["issued"] == got["useful"] + got["late"] + got["wasted"]


def test_golden_predictor_accuracy_smoke(golden):
    """Same cell the CI predictor-accuracy smoke runs: at a cache the
    working set nearly fits (8e5 B) with a mild confidence gate, the
    request predictor repays more fills than it writes off."""
    trace, _expected = golden
    rep = replay_trace(trace, prefetch_top_m=4, prefetch_kind="request",
                       prefetch_lookahead=2, prefetch_min_obs=2,
                       prefetch_min_score=0.05, async_io=True,
                       warmup="empty", cache_bytes=8e5)
    p = rep.prefetch
    assert p["in_flight"] == 0
    assert p["issued"] == p["useful"] + p["late"] + p["wasted"]
    assert p["useful"] > p["wasted"], p


def test_golden_replay_is_deterministic(golden):
    """Two independent replays of the same fixture agree bit-for-bit —
    the property the whole golden gate rests on."""
    trace, expected = golden
    ov = expected["configs"]["request_prefetch"]["overrides"]
    a, b = replay_trace(trace, **ov), replay_trace(trace, **ov)
    assert a.epoch_counts == b.epoch_counts
    assert a.miss_curve == b.miss_curve
    assert a.total_energy_j == b.total_energy_j
    assert a.prefetch == b.prefetch
