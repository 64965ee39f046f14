"""The port's kernel micro-benchmark (``benchmarks/torch_kernels_micro.py``)
on the CPU.

* Its analytic weight-byte rows equal the reference's persisted
  ``results/BENCH_kernels_micro.json`` exactly at the full shape
  (E=8, C=64, K=512, N=256), for every paper MAT config.
* ``main(quick=True, device="cpu")`` runs and writes its CSV and JSON only
  where ``torch_common``'s output directories point (here ``tmp_path``);
  off the card its rows are host times and its device times are null.
* On the CPU the wrappers of K1 (``amat_expert_matmul_qt``), K3
  (``amat_matmul_qt``) and K4 (``expert_matmul_qt``) run their plain
  versions, on codes quantized at MAT42 and MAT63 (shifts 2 and 3), and
  those agree with the reference's ``jnp`` versions at atol 1e-4.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.amat_matmul import ref as JR
from repro.kernels.expert_matmul import ref as JER
from repro_torch.core.amat import PAPER_CONFIGS, amat_quantize
from repro_torch.kernels.amat_matmul import ops as amat_ops
from repro_torch.kernels.amat_matmul import ref as TR
from repro_torch.kernels.expert_matmul import ops as expert_ops
from repro_torch.kernels.expert_matmul import ref as TER

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmarks import torch_common as TC  # noqa: E402
from benchmarks import torch_kernels_micro as KM  # noqa: E402

torch.set_num_threads(1)


def test_analytic_bytes_equal_the_reference_baseline():
    with open(os.path.join(ROOT, "results", "BENCH_kernels_micro.json")) as f:
        ref = json.load(f)
    (_, K, N), (E, C) = KM.shapes(quick=False)
    assert ref["shape"] == {"E": E, "C": C, "K": K, "N": N}
    assert [c.name for c in PAPER_CONFIGS] == \
        sorted(ref["dense_vs_quant_execution"])
    for mat in PAPER_CONFIGS:
        want = ref["dense_vs_quant_execution"][mat.name]
        got = KM.analytic_bytes(E, K, N, mat)
        for key in ("dense_dequant_bytes", "quant_execution_bytes",
                    "reduction_x"):
            assert got[key] == want[key], (mat.name, key)
    assert KM.analytic_bytes(E, K, N, PAPER_CONFIGS[-1])["reduction_x"] >= 2


def test_quick_main_writes_only_under_its_output_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(TC, "RESULTS", str(tmp_path))
    monkeypatch.setattr(TC, "BENCH_DIR", str(tmp_path / "bench"))
    record = KM.main(quick=True, device="cpu")
    written = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == ["BENCH_torch_kernels_micro.json",
                       "bench/torch_kernels_micro.csv"]
    with open(tmp_path / "BENCH_torch_kernels_micro.json") as f:
        assert json.load(f) == json.loads(json.dumps(record))
    assert record["device"] == {"type": "cpu"}
    assert record["route"] == "wrapper_plain"
    rows = (tmp_path / "bench" / "torch_kernels_micro.csv").read_text()
    assert "pallas" not in rows and "interp" not in rows
    names = [line.split(",")[0] for line in rows.splitlines()[1:]]
    assert all("plain" in n or n.startswith("weight_bytes") for n in names)
    assert all(n.endswith(("[wrapper_host]", "[host]"))
               for n in names if not n.startswith("weight_bytes"))
    for mat in PAPER_CONFIGS:
        row = record["dense_vs_quant_execution"][mat.name]
        # Off the card there is no device time; the host times remain.
        assert row["kernel_us"] is None and row["plain_us"] is None
        assert row["wrapper_host_us"] > 0 and row["plain_host_us"] > 0
        assert "decode" not in row
        assert {"pallas_interp_us", "dense_ref_jit_us"}.isdisjoint(row)


def _case(mat, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 7, 96), dtype=np.float32)
    w = rng.standard_normal((5, 96, 48), dtype=np.float32) * np.float32(0.1)
    use_lsb = np.array([True, False, True, False, False])
    qt = amat_quantize(torch.from_numpy(w), mat)
    return x, qt, use_lsb


@pytest.mark.parametrize("mat", PAPER_CONFIGS[:2], ids=lambda m: m.name)
def test_k1_wrapper_at_other_mats(mat):
    x, qt, ul = _case(mat, 1)
    tx, tul = torch.from_numpy(x), torch.from_numpy(ul)
    got = amat_ops.amat_expert_matmul_qt(tx, qt, tul, shift=mat.shift)
    plain = TR.amat_batched_matmul_ref(tx, qt.codes, qt.scales,
                                       qt.zero_points, tul, shift=mat.shift)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    ref = JR.amat_batched_matmul_ref(
        jnp.asarray(x), jnp.asarray(qt.codes.numpy()),
        jnp.asarray(qt.scales.numpy()), jnp.asarray(qt.zero_points.numpy()),
        jnp.asarray(ul), group_size=32, shift=mat.shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("mode", ["low", "high"])
@pytest.mark.parametrize("mat", PAPER_CONFIGS[:2], ids=lambda m: m.name)
def test_k3_wrapper_at_other_mats(mat, mode):
    x, qt, _ = _case(mat, 2)
    one = qt.index(1)
    tx = torch.from_numpy(x[1])
    got = amat_ops.amat_matmul_qt(tx, one, shift=mat.shift, mode=mode)
    plain = TR.amat_matmul_ref(tx, one.codes, one.scales, one.zero_points,
                               shift=mat.shift, mode=mode)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    ref = JR.amat_matmul_ref(
        jnp.asarray(x[1]), jnp.asarray(one.codes.numpy()),
        jnp.asarray(one.scales.numpy()), jnp.asarray(one.zero_points.numpy()),
        group_size=32, shift=mat.shift, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("mat", PAPER_CONFIGS[:2], ids=lambda m: m.name)
def test_k4_wrapper_at_other_mats(mat):
    x, qt, ul = _case(mat, 3)
    tx, tul = torch.from_numpy(x), torch.from_numpy(ul)
    got = expert_ops.expert_matmul_qt(tx, qt, tul, shift=mat.shift)
    plain = TER.expert_matmul_ref(tx, qt.codes, qt.scales, qt.zero_points,
                                  tul, shift=mat.shift)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    ref = JER.expert_matmul_ref(
        jnp.asarray(x), jnp.asarray(qt.codes.numpy()),
        jnp.asarray(qt.scales.numpy()), jnp.asarray(qt.zero_points.numpy()),
        jnp.asarray(ul), group_size=32, shift=mat.shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
