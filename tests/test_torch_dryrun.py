"""Port parity: the shape dry-run and the roofline tools over its records.

* ``run_pair`` on every arch's reduced config, each shape, both meshes:
  the reference's status and skip reason (``shape_supported``), its
  ``analytic_costs`` exactly, terms equal to the analytic flops and bytes
  over ``n_chips`` x the ``H100`` constants (never a TPU constant),
  ``collectives`` and ``collective_s`` null with their reasons,
  ``model_flops`` / ``useful_flops_ratio`` / ``bytes_per_chip`` by the
  reference's formulas, the argument bytes those of ``input_specs``.
  ``VARIANTS`` equal the reference's; a ``qserve`` prefill errs in both
  packages (neither prefill step passes a ``MatConfig``).
* Records are written where ``--all`` resumes from.
* XLA's ``argument_size_in_bytes`` is already per device (a subprocess
  on 8 host devices), so the reference's ``bytes_per_chip`` divides a
  per-device figure by the chip count once more.
* ``benchmarks/torch_roofline.py``, ``scripts/torch_make_tables.py`` and
  ``examples/roofline_report_torch.py`` give the expected rows from a
  fixture directory of records.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as j_config
from repro.launch import costs as JCOST
from repro.launch.steps import shape_supported as j_supported
from repro_torch.configs import base as TC
from repro_torch.hw.specs import H100, TPU_V5E
from repro_torch.launch import dryrun as TD
from repro_torch.launch import specs as TSPEC
from repro_torch.launch.mesh import make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_variants() -> dict:
    import ast

    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("VARIANTS not found")


def test_variants_equal_reference():
    assert TD.VARIANTS == _ref_variants()


# The shapes' names (which the skip and window rules read) at 256
# positions: a meta run's host time grows with the sequence (key blocks,
# SSM chunks), and the cost model's equality holds at any length.  The
# full shapes run in ``--all`` and in chip_smoke.py's phase 16a.
CUT = {k: dataclasses.replace(s, seq_len=256) for k, s in TC.SHAPES.items()}


def _reduced(monkeypatch):
    """``run_pair`` on each arch's reduced config, at the cut shapes."""
    monkeypatch.setattr(TD, "SHAPES", CUT)
    monkeypatch.setattr(TD, "get_config",
                        lambda arch: TC.get_config(arch).reduced())


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_pair_matches_reference(arch, mesh_kind, monkeypatch):
    _reduced(monkeypatch)
    t, j = TC.get_config(arch).reduced(), j_config(arch).reduced()
    n = 512 if mesh_kind == "multi" else 256
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                abstract=True)
    for name, shape in CUT.items():
        rec = TD.run_pair(arch, name, mesh_kind, save=False)
        ok, why = j_supported(j, shape)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_chips"] == n
        ac = JCOST.analytic_costs(j, shape)
        assert rec["analytic"] == {"flops": ac.flops,
                                   "hbm_bytes": ac.hbm_bytes, **ac.detail}
        rl = rec["roofline"]
        assert rl["compute_s"] == ac.flops / (n * H100.peak_flops_bf16)
        assert rl["memory_s"] == ac.hbm_bytes / (n * H100.hbm_bytes_per_s)
        assert rl["compute_s"] != ac.flops / (n * TPU_V5E.peak_flops_bf16)
        assert rl["collective_s"] is None and rl["collective_s_reason"]
        assert rec["collectives"] is None and rec["collectives_reason"]
        assert rl["dominant"] == max(("compute_s", "memory_s"),
                                     key=lambda k: rl[k])
        mf = JCOST.model_flops_reference(j, shape)
        assert rl["model_flops"] == mf == TD.model_flops(t, shape)
        assert rl["useful_flops_ratio"] == mf / ac.flops
        args = TSPEC.argument_size_in_bytes(TSPEC.input_specs(t, shape,
                                                              mesh))
        assert rec["memory"] == {"argument_size_in_bytes": args}
        assert rl["bytes_per_chip"] == args / n
        assert set(rec["memory_reason"]) == {"temp_size_in_bytes",
                                             "output_size_in_bytes"}


def test_variant_applies_and_qserve_prefill_errs_as_in_the_reference(
        monkeypatch):
    _reduced(monkeypatch)
    rec = TD.run_pair("llama4-scout-17b-a16e", "decode_32k", "single",
                      save=False, variant="int8kv")
    j = dataclasses.replace(j_config("llama4-scout-17b-a16e").reduced(),
                            kv_dtype="int8")
    assert rec["status"] == "ok" and rec["variant"] == "int8kv"
    assert rec["analytic"]["kv_traffic"] == JCOST.analytic_costs(
        j, CUT["decode_32k"]).detail["kv_traffic"]
    rec = TD.run_pair("llama4-scout-17b-a16e", "decode_32k", "single",
                      save=False, variant="qserve")
    assert rec["status"] == "ok"
    rec = TD.run_pair("llama4-scout-17b-a16e", "prefill_32k", "single",
                      save=False, variant="qserve")
    assert rec["status"] == "error" and "MatConfig" in rec["error"]


@pytest.mark.parametrize("variant", ["baseline", "seqpar_dots"])
def test_train_pair_checkpoints_each_period_on_meta(variant, monkeypatch):
    """A train pair's step on ``meta`` runs each period under activation
    checkpointing: the default policy (``"full"``) and ``seqpar_dots``'s
    ``"dots"``, whose selective policy then sees the meta tensors."""
    from repro_torch.models import model as TM

    _reduced(monkeypatch)
    n = {"checkpoint": 0, "policy": 0}
    checkpoint, policy = TM.CK.checkpoint, TM._dots_policy

    def checkpoint_(*a, **kw):
        n["checkpoint"] += 1
        return checkpoint(*a, **kw)

    def policy_(ctx, op, *args, **kw):
        n["policy"] += 1
        assert all(t.device.type == "meta" for t in args
                   if isinstance(t, TM.torch.Tensor))
        return policy(ctx, op, *args, **kw)

    monkeypatch.setattr(TM.CK, "checkpoint", checkpoint_)
    monkeypatch.setattr(TM, "_dots_policy", policy_)
    rec = TD.run_pair("smollm-360m", "train_4k", "single", save=False,
                      variant=variant)
    assert rec["status"] == "ok", rec.get("traceback")
    assert n["checkpoint"] == TC.get_config("smollm-360m").reduced().n_periods
    assert (n["policy"] > 0) == (variant == "seqpar_dots")


def test_records_saved_and_resumed(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TD, "RESULTS_DIR", str(tmp_path))
    _reduced(monkeypatch)
    for arch in ARCH_IDS:
        for shape in TC.SHAPES:
            for mesh in ("single", "multi"):
                TD._save({"arch": arch, "shape": shape, "mesh": mesh,
                          "variant": "baseline", "status": "skipped",
                          "reason": "fixture"})
    TD.run_pair("smollm-360m", "decode_32k", "single", variant="int8kv")
    assert (tmp_path / "smollm-360m__decode_32k__single__int8kv.json").exists()
    assert TD._already_done("gemma-7b", "train_4k", "multi")
    monkeypatch.setattr(sys, "argv", ["dryrun", "--all"])

    def no_subprocess(*a, **kw):
        raise AssertionError("a recorded pair was run again")

    monkeypatch.setattr(TD.subprocess, "run", no_subprocess)
    assert TD.main() == 0
    out = capsys.readouterr().out
    assert out.count("[skip-cached]") == 80 and "done; 0 failures" in out


def test_xla_argument_bytes_are_per_device():
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.make_mesh((8,), ("d",))
        sh = jax.ShapeDtypeStruct((1024, 256), jnp.float32,
                                  sharding=NamedSharding(mesh, P("d")))
        rep = jax.ShapeDtypeStruct((1024, 256), jnp.float32,
                                   sharding=NamedSharding(mesh, P()))
        c = jax.jit(lambda a, b: a.sum() + b.sum()).lower(sh, rep).compile()
        print(c.memory_analysis().argument_size_in_bytes)
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    full = 1024 * 256 * 4
    assert int(out.stdout.split()[-1]) == full // 8 + full


# ------------------------------------------------------- the roofline tools
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_torch")
    mp = pytest.MonkeyPatch()
    mp.setattr(TD, "RESULTS_DIR", str(d))
    _reduced(mp)
    for arch in ("smollm-360m", "whisper-small"):
        for shape in TC.SHAPES:
            for mesh in ("single", "multi"):
                TD.run_pair(arch, shape, mesh)
    TD.run_pair("smollm-360m", "decode_32k", "single", variant="int8kv")
    mp.undo()
    return d


def _rec(d, name):
    return json.loads((d / f"{name}.json").read_text())


def test_torch_roofline_rows(records, tmp_path, monkeypatch, capsys):
    from benchmarks import torch_common
    from benchmarks import torch_roofline as TR

    table, counts = TR.rows(str(records))
    assert counts == {"ok": 7, "skipped": 1, "missing": 64,
                      "dominant": counts["dominant"]}
    assert sum(counts["dominant"].values()) == 7
    assert len(table) == 16 and all(len(r) == len(TR.HEADER) for r in table)
    rec = _rec(records, "smollm-360m__train_4k__single")
    row = table[0]
    assert row[:4] == ["smollm-360m", "train_4k", "single", "ok"]
    assert row[4] == f"{rec['roofline']['compute_s']:.3e}" and row[6] == ""
    skipped = [r for r in table if r[3] == "skipped"]
    assert [r[:3] for r in skipped] == [
        ["whisper-small", "long_500k", "single"],
        ["whisper-small", "long_500k", "multi"]]
    monkeypatch.setattr(torch_common, "BENCH_DIR", str(tmp_path))
    TR.main(dryrun_dir=str(records))
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("torch_roofline,") and "ok=7/40" in out
    csv = (tmp_path / "torch_roofline.csv").read_text().splitlines()
    assert csv[0] == ",".join(TR.HEADER) and len(csv) == 17


def test_make_tables_and_report(records):
    mt = _load("scripts/torch_make_tables.py", "torch_make_tables")
    rr = _load("examples/roofline_report_torch.py", "roofline_report_torch")
    dry = mt.dryrun_table(str(records))
    assert len(dry) == 2 + 16
    assert sum("| SKIP |" in line for line in dry) == 2
    rec = _rec(records, "whisper-small__prefill_32k__multi")
    line = next(x for x in dry if x.startswith(
        "| whisper-small | prefill_32k | multi | ok | 512 |"))
    assert f"{rec['roofline']['analytic_flops']:.2e}" in line
    assert "| n/a |" in line
    roof = mt.roofline_table(str(records))
    assert len(roof) == 2 + 8
    assert "| whisper-small | long_500k | - | - | - | skipped | - | - |" \
        in roof
    lines = rr.report_lines("single", str(records))
    text = "\n".join(lines)
    assert "=== smollm-360m ===" in text and "=== gemma-7b ===" in text
    assert text.count("no record") == 8 * 4
    assert "SKIP: full-attention arch" in text
    best = next(x for x in lines if x.strip().startswith("decode_32k")
                and "best variant" in x)
    assert "[best variant: int8kv ->" in best
