"""Top-level ATen calls per batched decode step of the port's engine.

    python3 scripts/torch_decode_ops.py [ROOT ...]

Counts, with ``torch.profiler`` on the CPU, the ATen calls that the
engine's decode forward (``PersistentEngine._decode``: Cache-Prior +
DBSC, 4 sequences) dispatches from Python, for ``qwen15-moe-repro`` at 2
and 4 layers, so that the count per MoE layer and the fixed part
separate.  On the card each is at least one launch or host dispatch,
and the decode step is host-bound (``PERF.md`` §5), so this count moves
its wall.  A count, not a time: it needs no card.  Each ROOT (default:
this checkout) is counted in its own process, to set a parent commit
(unpacked with ``git archive``) beside a change.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import dataclasses, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs.base import get_config
from repro_torch.core.amat import MatConfig
from repro_torch.core.engine import EngineConfig, PersistentEngine
from repro_torch.models.model import init_params
from repro_torch.models.moe import RoutingPolicy

torch.set_num_threads(1)
counts = {}
for layers in (2, 4):
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=layers)
    eng = PersistentEngine(
        cfg, init_params(cfg, seed=0, device="cpu"),
        EngineConfig(mat=MatConfig(8, 4), cache_bytes=2e6, max_seq=40,
                     policy=RoutingPolicy(kind="cache_prior",
                                          slice_mode="dbsc")),
        device="cpu")
    cache = eng.init_batch_cache(4)
    tok = torch.zeros(4, dtype=torch.long)
    eng.decode_batch(tok, cache)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng._decode(tok, cache, 0.0, None)
    counts[layers] = sum(1 for e in prof.events()
                         if e.key.startswith("aten::") and e.cpu_parent is None)
per_layer = (counts[4] - counts[2]) / 2
print(f"top-level ATen calls per decode step: {counts[2]} at 2 layers, "
      f"{counts[4]} at 4; {per_layer:g} per MoE layer, "
      f"{counts[2] - 2 * per_layer:g} fixed")
"""


def main() -> None:
    for root in sys.argv[1:] or ["."]:
        out = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-2000:]}")
        print(f"{root}: {out.stdout.strip().splitlines()[-1]}")


if __name__ == "__main__":
    main()
