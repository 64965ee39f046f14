"""The plain reference against the port, its control, and the harness's
independence from JAX and the JAX package (CPU, small sizes)."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench.lib import bench, loader, reference as R
from portbench.tests.cells import QWEN_REPRO, ROOT, TINY_HYBRID, cell

CFGS = {"qwen15-moe-repro": QWEN_REPRO, "tiny-hybrid": TINY_HYBRID}
# At float32 the program and the reference differ in the order of f32
# sums only: every served token is the reference's best to rounding.
F32_LIMITS = {"max_gap": 1e-3, "mean_gap": 1e-4}


def _run(cfg, seed, control=False, seconds=4.0, **limits):
    c = cell(cfg, **(limits or {"max_gap": F32_LIMITS["max_gap"],
                                "mean_gap": F32_LIMITS["mean_gap"]}))
    torch.manual_seed(0)
    return bench.run_cell(c, seed, seconds, False, torch.device("cpu"),
                          time.perf_counter(), control=control)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_port_matches_reference_and_control_does_not(name):
    res = _run(CFGS[name], 2 ** 31 + 11, control=True)
    ch = res["checks"]
    assert ch["tokens_judged"]["value"] > 0
    assert res["correct"], ch
    assert res["failed"] == 0 and res["attempted"] > 0
    assert ch["mean_logit_gap"]["value"] <= F32_LIMITS["mean_gap"]
    # The float8 control fails the same limits by far.
    assert ch["control_mean_logit_gap"]["value"] > \
        100 * F32_LIMITS["mean_gap"]
    assert ch["control_logit_gap"]["value"] > F32_LIMITS["max_gap"]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_weight_tree_is_the_programs_input_format(name):
    from repro_torch.models.model import param_shapes

    cfg = CFGS[name]
    model = loader.model_module(cfg)
    assert model.shape_tree(cfg) == param_shapes(model.program_config(cfg))


def test_capacity_rule_matches_the_programs_dispatch():
    from repro_torch.models.moe import dispatch_indices

    rng = np.random.default_rng(0)
    E, k = 6, 3
    for _ in range(20):
        T = int(rng.integers(4, 40))
        ids = rng.integers(0, E + 1, (T, k))
        cap = R.capacity(T, k, E, 1.25)
        _, keep = dispatch_indices(torch.as_tensor(ids),
                                   torch.ones(T, k), E, cap)
        ours = R.keep_mask(ids, E, cap) | (ids == E)
        assert np.array_equal(ours, keep.numpy())


def test_amat_dequant_matches_the_programs_codes():
    from repro_torch.core.amat import MAT84, amat_quantize, dequant_mixed

    w = torch.randn(128, 96, generator=torch.Generator().manual_seed(1))
    hi, lo = R.amat_dequant(w)
    qt = amat_quantize(w, MAT84)
    for flag, ours in ((True, hi), (False, lo)):
        theirs = dequant_mixed(
            type(qt)(qt.codes[None], qt.scales[None], qt.zero_points[None],
                     qt.bits, qt.group_size, qt.asymmetric),
            torch.tensor([flag]), MAT84.shift)[0]
        assert torch.equal(ours, theirs)


def test_a_cell_loads_neither_jax_nor_the_jax_package():
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from portbench.lib import bench
from portbench.tests.cells import cell, QWEN_REPRO
res = bench.run_cell(cell(QWEN_REPRO, 1e-3, 1e-4), 3, 0.5, True,
                     torch.device("cpu"), time.perf_counter())
print(json.dumps([res["correct"], res["banned_modules"],
                  sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                "repro"))]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, banned, seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert banned == [] and seen == []
    assert correct
    # The check compares whole top-level names: the port's own name
    # begins with the JAX package's and is not caught; the package is.
    assert [m for m in ("repro_torch.core", "repro_torch", "repro.core",
                        "repro", "jax.numpy")
            if m.split(".")[0] in bench.BANNED] == ["repro.core", "repro",
                                                   "jax.numpy"]
