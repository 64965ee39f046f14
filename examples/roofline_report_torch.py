"""Read the port's dry-run records and print the roofline story per arch
(the counterpart of ``examples/roofline_report.py``; imports no JAX).

For each architecture: the dominant term per input shape on the card
(``hw.specs.H100``), and, when variant records exist
(``python -m repro_torch.launch.dryrun --variant ...``), the variant
that lowers the dominant term most.  The records hold no collective
term (``launch/dryrun.py``), so the dominant term is the larger of the
compute and memory terms.

Run:  python examples/roofline_report_torch.py [--mesh single] [--dir DIR]
"""

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

from repro_torch.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN  # noqa: E402

TERMS = ("compute_s", "memory_s")


def load(arch, shape, mesh, variant=None, dryrun_dir=DRYRUN):
    suffix = f"__{variant}" if variant else ""
    p = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}{suffix}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def report_lines(mesh: str = "single", dryrun_dir: str = DRYRUN) -> list:
    lines = []
    for arch in ARCH_IDS:
        lines.append(f"\n=== {arch} ===")
        for shape in SHAPES:
            rec = load(arch, shape, mesh, dryrun_dir=dryrun_dir)
            if rec is None:
                lines.append(f"  {shape:12s} (no record — run dryrun --all)")
                continue
            if rec["status"] == "skipped":
                lines.append(f"  {shape:12s} SKIP: {rec['reason'][:60]}...")
                continue
            if rec["status"] != "ok":
                lines.append(f"  {shape:12s} ERROR: {rec.get('error', '')}")
                continue
            rl = rec["roofline"]
            dom = rl["dominant"].replace("_s", "")
            line = (f"  {shape:12s} {dom:10s} "
                    f"c={rl['compute_s']:.1e} m={rl['memory_s']:.1e}")
            pat = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}__*.json")
            best = None
            for vp in sorted(glob.glob(pat)):
                with open(vp) as f:
                    v = json.load(f)
                if v["status"] != "ok":
                    continue
                vd = max(v["roofline"][t] for t in TERMS)
                if best is None or vd < best[0]:
                    best = (vd, v["variant"])
            if best is not None:
                base_dom = max(rl[t] for t in TERMS)
                gain = base_dom / max(best[0], 1e-15)
                line += f"   [best variant: {best[1]} -> {gain:.1f}x]"
            lines.append(line)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--dir", default=DRYRUN,
                    help="directory of the dry-run records")
    args = ap.parse_args(argv)
    print("\n".join(report_lines(args.mesh, args.dir)))


if __name__ == "__main__":
    main()
