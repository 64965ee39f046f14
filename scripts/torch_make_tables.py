"""Render the port's dry-run tables from ``results/dryrun_torch/*.json``
(the counterpart of ``scripts/make_tables.py``; imports no JAX).

Usage: PYTHONPATH=src python scripts/torch_make_tables.py
       [--section dryrun|roofline] [--dir DIR]
Prints markdown to stdout.  The port's records hold no raw HLO numbers
and no collective bytes (``launch/dryrun.py``), so the dry-run table
gives the analytic flops and one device's argument bytes in their place
and ``n/a`` for the collectives.
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

from repro_torch.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN  # noqa: E402


def load(mesh, dryrun_dir: str = DRYRUN):
    out = {}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            p = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(p):
                with open(p) as f:
                    out[(arch, shape)] = json.load(f)
    return out


def fmt(x, spec=".2e"):
    return format(x, spec) if isinstance(x, (int, float)) else str(x)


def dryrun_table(dryrun_dir: str = DRYRUN) -> list:
    lines = ["| arch | shape | mesh | status | chips | args/device | "
             "bytes/chip | analytic flops | collective GB | compile s |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for mesh in ("single", "multi"):
        for (arch, shape), rec in sorted(load(mesh, dryrun_dir).items()):
            if rec["status"] == "skipped":
                lines.append(f"| {arch} | {shape} | {mesh} | SKIP | - | - | "
                             "- | - | - | - |")
                continue
            if rec["status"] != "ok":
                lines.append(f"| {arch} | {shape} | {mesh} | ERROR | - | - | "
                             "- | - | - | - |")
                continue
            rl = rec["roofline"]
            args = rec["memory"]["argument_size_in_bytes"]
            lines.append(
                f"| {arch} | {shape} | {mesh} | ok | {rec['n_chips']} | "
                f"{args / 2**30:.2f} GiB | "
                f"{rl['bytes_per_chip'] / 2**30:.2f} GiB | "
                f"{fmt(rl['analytic_flops'])} | n/a | {rec['compile_s']} |")
    return lines


def roofline_table(dryrun_dir: str = DRYRUN) -> list:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL/analytic FLOPs | what moves the dominant "
             "term |",
             "|---|---|---|---|---|---|---|---|"]
    hints = {
        ("compute_s", "train"): "more cards / lower remat (selective ckpt)",
        ("compute_s", "prefill"): "sharper expert capacity factor",
        ("compute_s", "decode"): "quantized matmul (fp8 / int8 tensor "
                                 "cores)",
        ("memory_s", "train"): "optimizer-state dtype / fused opt update",
        ("memory_s", "prefill"): "KV cache dtype (int8), fusion",
        ("memory_s", "decode"): "weight quantization (AMAT int8/int4 reads)",
    }
    for (arch, shape), rec in sorted(load("single", dryrun_dir).items()):
        if rec["status"] != "ok":
            lines.append(f"| {arch} | {shape} | - | - | - | skipped | - | "
                         "- |")
            continue
        rl = rec["roofline"]
        kind = SHAPES[shape].kind
        hint = hints.get((rl["dominant"], kind), "")
        lines.append(
            f"| {arch} | {shape} | {fmt(rl['compute_s'])} | "
            f"{fmt(rl['memory_s'])} | n/a | "
            f"**{rl['dominant'].replace('_s', '')}** | "
            f"{rl['useful_flops_ratio']:.2f} | {hint} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default="roofline",
                    choices=["dryrun", "roofline"])
    ap.add_argument("--dir", default=DRYRUN,
                    help="directory of the dry-run records")
    args = ap.parse_args(argv)
    table = dryrun_table if args.section == "dryrun" else roofline_table
    print("\n".join(table(args.dir)))


if __name__ == "__main__":
    main()
