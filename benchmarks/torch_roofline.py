"""Roofline aggregation of the port's dry-run (the counterpart of
``benchmarks/roofline.py``; imports no JAX): reads
``results/dryrun_torch/*.json`` (``python -m repro_torch.launch.dryrun
--all``) into one CSV row per (arch, shape, mesh).

Single-pod (16x16) records feed the counts; multi-pod rows show the pod
axis sharding the arguments.  For each pair: the compute and memory
terms in seconds on the card (``hw.specs.H100``), the dominant term, the
MODEL/analytic FLOPs ratio and bytes per chip.  The CSV keeps the
reference's header; its ``collective_s`` column is empty, since the
port's records hold ``null`` there (no partitioner, no collectives).
Reads records only; ``--device`` is accepted for the sweep runner and
unused.

Run:  PYTHONPATH=src python benchmarks/torch_roofline.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

from benchmarks.torch_common import CsvSink, report  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN_DIR  # noqa: E402

HEADER = ["arch", "shape", "mesh", "status", "compute_s", "memory_s",
          "collective_s", "dominant", "useful_flops_ratio",
          "bytes_per_chip_gb", "compile_s"]


def load_all(mesh: str = "single", dryrun_dir: str = DRYRUN_DIR) -> dict:
    out = {}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            p = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(p):
                with open(p) as f:
                    out[(arch, shape)] = json.load(f)
    return out


def _fmt_s(x) -> str:
    return "" if x is None else f"{x:.3e}"


def rows(dryrun_dir: str = DRYRUN_DIR):
    """(CSV rows, counts): every pair of both meshes, and the single-pod
    mesh's ``ok`` / ``skipped`` / ``missing`` counts and dominant
    terms."""
    out = []
    n_ok = n_skip = n_missing = 0
    dominants = {}
    for mesh in ("single", "multi"):
        recs = load_all(mesh, dryrun_dir)
        for arch in ARCH_IDS:
            for shape in SHAPES:
                rec = recs.get((arch, shape))
                if rec is None:
                    n_missing += 1
                    continue
                if rec["status"] == "skipped":
                    if mesh == "single":
                        n_skip += 1
                    out.append([arch, shape, mesh, "skipped", "", "", "", "",
                                "", "", ""])
                    continue
                if rec["status"] != "ok":
                    out.append([arch, shape, mesh, rec["status"], "", "", "",
                                "", "", "", ""])
                    continue
                rl = rec["roofline"]
                if mesh == "single":
                    n_ok += 1
                    dominants[rl["dominant"]] = \
                        dominants.get(rl["dominant"], 0) + 1
                out.append([arch, shape, mesh, "ok",
                            _fmt_s(rl["compute_s"]), _fmt_s(rl["memory_s"]),
                            _fmt_s(rl["collective_s"]),
                            rl["dominant"].replace("_s", ""),
                            round(rl["useful_flops_ratio"] or 0, 3),
                            round(rl["bytes_per_chip"] / 2**30, 3),
                            rec.get("compile_s", "")])
    return out, {"ok": n_ok, "skipped": n_skip, "missing": n_missing,
                 "dominant": dominants}


def main(quick: bool = False, device=None,
         dryrun_dir: str = DRYRUN_DIR) -> dict:
    t0 = time.perf_counter()
    sink = CsvSink("torch_roofline", HEADER)
    table, counts = rows(dryrun_dir)
    for row in table:
        sink.add(*row)
    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    report("torch_roofline", us,
           f"ok={counts['ok']}/40;skipped={counts['skipped']};"
           f"missing={counts['missing']};dominant={counts['dominant']};"
           f"csv={path}")
    return counts


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="accepted for the sweep runner; the same run")
    ap.add_argument("--device", default=None,
                    help="accepted for the sweep runner; unused")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
