"""Port parity: the shape records, parameter counts, analytic costs and
roofline constants of the launch layer.

* ``SHAPES`` equals the reference's field for field; ``CacheDims`` and
  ``AttnDims`` (with ``q_rep``) too.
* ``param_count`` and ``active_param_count`` equal the reference's
  (exact ints) for every config of ``ARCH_IDS + REPRO_IDS``.
* ``launch.costs``: ``analytic_costs`` (``flops``, ``hbm_bytes``, every
  ``detail`` leaf), ``param_bytes`` and ``model_flops_reference`` equal
  the reference's at rtol 1e-12, for every arch x shape x dry-run
  variant that ``shape_supported`` admits.
* Every public name of the reference's ``launch/{costs,mesh,sharding,
  specs,steps,train,dryrun}.py`` has a counterpart in the port, but for
  the HLO parser of the dry-run (the port has no HLO).
* ``hw.specs``: ``TPU_V5E`` equals the reference's field by field and
  its terms too; ``H100`` holds the card's data-sheet constants, which
  ``chip_smoke.py``'s bounds read instead of constants of their own.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from repro.configs.base import ARCH_IDS, REPRO_IDS, SHAPES as J_SHAPES
from repro.configs.base import get_config as j_config
from repro.hw import specs as JSP
from repro.launch import costs as JCOST
from repro.launch.steps import shape_supported as j_supported
from repro.models.layers import AttnDims as JAttnDims
from repro.models.model import CacheDims as JCacheDims
from repro_torch.configs import base as TC
from repro_torch.hw import specs as TSP
from repro_torch.launch import costs as TCOST
from repro_torch.launch.steps import shape_supported as t_supported
from repro_torch.models.layers import AttnDims as TAttnDims
from repro_torch.models.model import CacheDims as TCacheDims

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _ref_variants() -> dict:
    """The reference's dry-run ``VARIANTS``, read from its source: the
    module sets ``XLA_FLAGS`` for 512 host devices when imported, which
    no test process may do."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("VARIANTS not found")


VARIANTS = _ref_variants()


# What the port leaves out instead of inventing (``launch/dryrun.py``):
# the reference's dry-run reads collectives from XLA's HLO text.
NO_HLO = {"parse_collectives"}


@pytest.mark.parametrize("module", ["costs", "mesh", "sharding", "specs",
                                    "steps", "train", "dryrun"])
def test_launch_modules_have_the_references_public_names(module):
    import importlib

    tree = ast.parse((ROOT / f"src/repro/launch/{module}.py").read_text())
    public = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            public.add(node.name)
        elif isinstance(node, ast.Assign):
            public.update(t.id for t in node.targets
                          if isinstance(t, ast.Name))
    public = {n for n in public if not n.startswith("_")} - NO_HLO
    port = importlib.import_module(f"repro_torch.launch.{module}")
    assert public <= set(dir(port)), public - set(dir(port))


def test_shapes_equal_reference_field_for_field():
    assert list(TC.SHAPES) == list(J_SHAPES)
    for name, ref in J_SHAPES.items():
        assert dataclasses.asdict(TC.SHAPES[name]) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(TC.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(type(J_SHAPES["train_4k"]))]


def test_dims_records_equal_reference():
    assert dataclasses.asdict(TCacheDims(3, 64)) == \
        dataclasses.asdict(JCacheDims(3, 64))
    for h, kv, hd in ((16, 16, 64), (40, 8, 128), (14, 2, 64)):
        t, j = TAttnDims(h, kv, hd), JAttnDims(h, kv, hd)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.q_rep == j.q_rep == h // kv
    with pytest.raises(dataclasses.FrozenInstanceError):
        TCacheDims(1, 2).batch = 3


@pytest.mark.parametrize("arch", ARCH_IDS + REPRO_IDS)
def test_param_counts_equal_reference(arch):
    t, j = TC.get_config(arch), j_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert isinstance(t.active_param_count(), int)
    assert TCOST.param_bytes(t) == JCOST.param_bytes(j)
    qt = dataclasses.replace(t, quantized_serve=True)
    qj = dataclasses.replace(j, quantized_serve=True)
    if t.has_moe:
        assert TCOST.param_bytes(qt) == JCOST.param_bytes(qj)
        assert qt.param_count() == qj.param_count()


def _close(a, b):
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_costs_equal_reference(arch, variant):
    t = dataclasses.replace(TC.get_config(arch), **VARIANTS[variant])
    j = dataclasses.replace(j_config(arch), **VARIANTS[variant])
    admitted = 0
    for name in J_SHAPES:
        ok_j, why_j = j_supported(j, J_SHAPES[name])
        assert t_supported(t, TC.SHAPES[name]) == (ok_j, why_j)
        if not ok_j:
            continue
        admitted += 1
        tc = TCOST.analytic_costs(t, TC.SHAPES[name])
        jc = JCOST.analytic_costs(j, J_SHAPES[name])
        assert _close(tc.flops, jc.flops), (name, tc.flops, jc.flops)
        assert _close(tc.hbm_bytes, jc.hbm_bytes), name
        assert set(tc.detail) == set(jc.detail)
        for k, v in jc.detail.items():
            assert _close(tc.detail[k], v), (name, k, tc.detail[k], v)
        assert _close(TCOST.model_flops_reference(t, TC.SHAPES[name]),
                      JCOST.model_flops_reference(j, J_SHAPES[name]))
    assert admitted >= 3


def test_tpu_record_equals_reference_and_h100_holds_the_card():
    assert dataclasses.asdict(TSP.TPU_V5E) == dataclasses.asdict(JSP.TPU_V5E)
    for term in ("compute_term_s", "memory_term_s", "collective_term_s"):
        assert getattr(TSP.TPU_V5E, term)(3.7e15, 256) == \
            getattr(JSP.TPU_V5E, term)(3.7e15, 256)
    h = TSP.H100
    assert h.peak_flops == {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}
    assert h.hbm_bytes_per_s == 3.35e12 and h.hbm_capacity_bytes == 80e9
    assert h.compute_term_s(989e12 * 4, 2) == 2.0
    assert h.memory_term_s(3.35e12, 1) == 1.0
    assert not hasattr(h, "collective_term_s")


def test_chip_smoke_bounds_read_the_h100_record():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "PEAK_FLOPS =" not in src and "HBM_BYTES_PER_S =" not in src
    tree = ast.parse(src)
    bound = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "_bound")
    assert "H100" in ast.unparse(bound)
    # The bounds of PERF.md's table, to the digit: K1's decode row at
    # 407.5 MB and K5's causal row at 412.4 GFLOP of bf16 work.
    ns = {}
    exec(compile(ast.Module([bound], []), "chip_smoke", "exec"), ns)
    ms, by = ns["_bound"](407.5e6, {"bf16": 2 * 60 * 8 * 2048 * 2816})
    assert (round(ms, 4), by) == (0.1216, "bytes")
    ms, by = ns["_bound"](1e6, {"bf16": 412.4e9})
    assert (round(ms, 4), by) == (0.4170, "operations")
    ms, _ = ns["_bound"](1e6, {"tf32": 824.8e9})
    assert round(ms, 4) == 1.6673
    assert np.isclose(ns["_bound"](0.0, {"f32": 67e12})[0], 1e3)
