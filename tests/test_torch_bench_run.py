"""Port parity: the sweep runner ``benchmarks/torch_run.py``.

* ``COMPARE_SKIP``, ``COMPARE_RTOL``, ``_leaf_rtol`` and ``_diff_payload``
  equal the reference's (``benchmarks/run.py`` imports only the standard
  library) on a set of keys and payload pairs.
* ``run_compare`` in a temporary directory: an unchanged payload passes,
  a perturbed one fails naming its leaf, a baseline made on another
  device type is listed as not comparable, and with none comparable the
  run exits.  The fresh run (one subprocess per benchmark, which takes
  tens of seconds to minutes each) is replaced by one that writes a
  given payload.
* ``BENCH_NAMES`` are the port's ten benchmark modules; ``--only
  torch_roofline`` runs inline and prints its CSV line; ``--help`` says
  why ``torch_serving_load`` has no baseline.
"""

import copy
import json
import os
import pathlib

import pytest

from benchmarks import run as JR
from benchmarks import torch_run as TR

ROOT = pathlib.Path(__file__).resolve().parents[1]

KEYS = ["kernel_us", "wall_s", "speedup_x", "steps_per_s", "ici_bytes",
        "dense_dequant_bytes", "energy_j", "miss_rate", "n_events", "E",
        "bytes_per_step_us", "x_dtype", ""]

PAIRS = [
    ({"a": 1.0}, {"a": 1.0}),
    ({"a": 1.0}, {"a": 1.0 + 1e-7}),
    ({"a": 1.0}, {"a": 1.1}),
    ({"ici_bytes": 10.0}, {"ici_bytes": 10.0000001}),
    ({"wall_s": 1.0, "x_us": 2.0}, {"wall_s": 9.0, "x_us": 7.0}),
    ({"a": {"b": [1, 2, 3]}}, {"a": {"b": [1, 2]}}),
    ({"a": {"b": 1}}, {"a": [1]}),
    ({"a": 1, "b": 2}, {"a": 1}),
    ({"a": 1}, {"a": 1, "new": {"x": 2}}),
    ({"s": "cuda", "f": True, "n": None}, {"s": "cpu", "f": False, "n": 0}),
    ({"a": {"wall": 1.0}}, {"a": {}}),
    ({"a": {"d": {"x": 1}}}, {"a": {}}),
    ({"l": [{"bytes": 4}, {"bytes": 5}]}, {"l": [{"bytes": 4},
                                                 {"bytes": 6}]}),
]


def test_compare_policy_equals_reference():
    assert TR.COMPARE_SKIP == JR.COMPARE_SKIP
    assert TR.COMPARE_RTOL == JR.COMPARE_RTOL
    for key in KEYS:
        assert TR._leaf_rtol(key) == JR._leaf_rtol(key), key


@pytest.mark.parametrize("prev,cur", PAIRS)
def test_diff_payload_equals_reference(prev, cur):
    out = []
    for mod in (TR, JR):
        diffs, news = [], []
        mod._diff_payload(prev, cur, "bench", diffs, news)
        out.append((diffs, news))
    assert out[0] == out[1]


PAYLOAD = {"device": "cpu", "arch": "qwen15-moe-repro",
           "ep2_replay": {"ici_bytes": 225280.0, "energy_j": 0.0125768},
           "pareto": ["cache=4MB,MAT63"], "sweep_wall_s": 3.2}


def _fake_fresh(payload):
    def run(name, scratch, device):
        with open(os.path.join(scratch, f"BENCH_{name}.json"), "w") as f:
            json.dump(payload, f)
        return 0, ""
    return run


def _baseline(tmp_path, name, payload):
    (tmp_path / f"BENCH_{name}.json").write_text(json.dumps(payload))


def test_run_compare_passes_on_an_unchanged_payload(tmp_path, monkeypatch,
                                                     capsys):
    _baseline(tmp_path, "torch_sim_fidelity", PAYLOAD)
    fresh = dict(PAYLOAD, sweep_wall_s=99.0)      # host time, skipped
    monkeypatch.setattr(TR, "_fresh_run", _fake_fresh(fresh))
    TR.run_compare(None, baseline_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "torch_sim_fidelity: OK" in out
    assert "all 1 baselined benchmark(s) reproduce" in out


def test_run_compare_fails_on_a_perturbed_payload(tmp_path, monkeypatch,
                                                  capsys):
    _baseline(tmp_path, "torch_sim_fidelity", PAYLOAD)
    fresh = copy.deepcopy(PAYLOAD)
    fresh["ep2_replay"]["ici_bytes"] += 1.0
    monkeypatch.setattr(TR, "_fresh_run", _fake_fresh(fresh))
    with pytest.raises(SystemExit, match="regressions in"):
        TR.run_compare("torch_sim_fidelity", baseline_dir=str(tmp_path),
                       device="cpu")
    out = capsys.readouterr().out
    assert "DIFF torch_sim_fidelity.ep2_replay.ici_bytes: baseline=" \
        "225280.0 current=225281.0  (rtol=0)" in out


def test_run_compare_holds_each_baseline_to_its_device(tmp_path,
                                                       monkeypatch, capsys):
    _baseline(tmp_path, "torch_sim_fidelity", PAYLOAD)
    _baseline(tmp_path, "torch_kernels_micro",
              {"device": {"type": "cuda"}, "route": "cuda"})
    (tmp_path / "BENCH_sim_fidelity.json").write_text("{}")   # reference's
    ran = []

    def fresh(name, scratch, device):
        ran.append((name, device))
        return _fake_fresh(PAYLOAD)(name, scratch, device)

    monkeypatch.setattr(TR, "_fresh_run", fresh)
    TR.run_compare(None, baseline_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert ran == [("torch_sim_fidelity", "cpu")]
    assert "torch_kernels_micro: baseline made on cuda; compares only on " \
        "a cuda run, not on cpu" in out
    with pytest.raises(SystemExit, match="made on cpu"):
        TR.run_compare("torch_kernels_micro", baseline_dir=str(tmp_path),
                       device="cpu")
    assert TR.baseline_device({"device": {"type": "cuda"}}) == "cuda"
    assert TR.baseline_device({"device": "cpu"}) == "cpu"
    assert TR.baseline_device({}) is None


def test_repo_baselines_name_their_devices():
    made_on = {}
    for p in sorted((ROOT / "results").glob("BENCH_torch_*.json")):
        made_on[p.stem[len("BENCH_"):]] = TR.baseline_device(
            json.loads(p.read_text()))
    assert made_on == {"torch_controller_soak": "cpu",
                       "torch_kernels_micro": "cuda",
                       "torch_sim_fidelity": "cpu"}


def test_bench_names_are_the_ports_modules(tmp_path, monkeypatch, capsys):
    assert len(TR.BENCH_NAMES) == len(JR.BENCH_NAMES) == 10
    assert TR.BENCH_NAMES == [f"torch_{n}" for n in JR.BENCH_NAMES]
    for name in TR.BENCH_NAMES:
        assert (ROOT / "benchmarks" / f"{name}.py").exists(), name
    from benchmarks import torch_common
    monkeypatch.setattr(torch_common, "BENCH_DIR", str(tmp_path))
    TR.main(["--only", "torch_roofline", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1].startswith("torch_roofline,")
    with pytest.raises(SystemExit):
        TR.main(["--help"])
    assert "torch_serving_load persists no record" in \
        capsys.readouterr().out.replace("\n", " ")
