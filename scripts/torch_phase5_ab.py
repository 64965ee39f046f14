"""Phase 5 of ``chip_smoke.py`` from several checkouts, in turns.

    python3 scripts/torch_phase5_ab.py build/parent . . build/parent

Each argument is the root of a checkout (unpack a parent commit with
``git archive`` under ``build/``, which git ignores).  For each, in the
order given, one process builds that checkout's kernels and serves
qwen15-moe-a2.7b at full width with phase 5's traffic (4 requests, 16
decode steps); its ``[serve]`` lines for the launches, the walls, the
peak memory and the fleet miss rate are printed under the root's name.
Needs one card; prints the card's name and power limit last.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import chip_smoke as C
from repro_torch.configs.base import get_config
C.phase_build()
C.phase_serving(get_config("qwen15-moe-a2.7b"))
"""
KEEP = ("kernel launches", "wall per decode", "max_memory", "fleet")


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"[ab] {root}: exit {out.returncode}\n"
                     f"{out.stderr[-2000:]}")
        print(f"[ab] {root}", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith("[serve]") and any(k in line for k in KEEP):
                print(line, flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
