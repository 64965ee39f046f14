"""Ablations beyond the paper's headline figures, on the port (the
counterpart of ``benchmarks/ablations.py``; imports no JAX).

1. **DBSC criticality threshold theta** (paper §4.1 "single-head"):
   sweep theta ∈ {0.3 … 0.9} — lower theta marks more experts critical
   (more LSB traffic, higher precision); theta=1.0 degenerates to
   uniform low-bit.
2. **LSB keep fraction in PCW** (paper §4.3 ties it to the single-head
   ratio): sweep lsb_keep_frac.
3. **Slice-aware vs single-LRU cache** (paper §4.1's heterogeneous
   management): same DBSC routing, cache with/without the LSB
   low-priority segment.
4. **Prefetching baseline** (paper §2.1): top-k routing with
   layer-transition prefetch of 4 experts.
5. **Storage**: bytes per expert to hold both precisions, AMAT's
   Matryoshka codes against HOBBIT-style duplicated copies (paper §2.2).

Energy and latency are the deterministic cost model's.  The model is
``torch_common.train_or_load``'s; the prompt is drawn with numpy from
seed 21.  The CSV is ``results/bench/torch_ablations.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_ablations.py [--quick]
      [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import CsvSink, report, train_or_load  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, SliceMoEEngine  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402

ARCH = "qwen15-moe-repro"
STEPS = 20
PROMPT = 48
CACHE_BYTES = 4e6
HEADER = ["ablation", "setting", "energy_mj", "latency_ms", "lsb_fetches",
          "miss_rate"]


def run(cfg, params, toks, *, device=None, quant_execution: bool = False,
        **over):
    """Decode energy (mJ) and latency (ms) (cost model), LSB fetches and
    miss rate of the base DBSC + PCW configuration with ``over`` applied.
    ``quant_execution`` runs the experts on their packed codes (the
    batched AMAT kernels on the card), in whatever policy ``over`` sets;
    the default dequantizes them in plain torch, as the reference does."""
    base = dict(mat=MatConfig(8, 4), cache_bytes=CACHE_BYTES,
                policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
                miss_rate_target=0.05, warmup="pcw", max_seq=96)
    base.update(over)
    if quant_execution:
        base["policy"] = dataclasses.replace(base["policy"],
                                             quant_execution=True)
    eng = SliceMoEEngine(cfg, params, EngineConfig(**base), device=device)
    logits = eng.prefill(toks)
    _, m = eng.decode(torch.argmax(logits, -1), STEPS)
    d = m["decode_totals"]
    s = m["cache_stats"]
    return {
        "energy_mj": d["total_energy_j"] * 1e3,
        "latency_ms": d["total_latency_s"] * 1e3,
        "lsb_fetches": s["lsb_hits"] + s["lsb_misses"],
        "miss_rate": (s["msb_misses"] + s["lsb_misses"])
        / max(s["msb_hits"] + s["msb_misses"]
              + s["lsb_hits"] + s["lsb_misses"], 1),
    }


def run_rows(cfg, params, toks, *, quick: bool = False, device=None,
             quant_execution: bool = False,
             cache_bytes: float = CACHE_BYTES):
    """The θ, ``lsb_keep_frac``, slice-aware-cache and ``prefetch_topk``
    rows: (ablation, setting, :func:`run`'s result) each, every run with a
    slice cache of ``cache_bytes``."""
    def one(**over):
        return run(cfg, params, toks, device=device,
                   quant_execution=quant_execution, cache_bytes=cache_bytes,
                   **over)

    rows = []
    thetas = (0.3, 0.5, 0.7, 0.9) if not quick else (0.5,)
    for th in thetas:
        rows.append(("theta", th, one(policy=RoutingPolicy(
            kind="cache_prior", slice_mode="dbsc", theta=th))))
    fracs = (0.05, 0.125, 0.3) if not quick else (0.125,)
    for fr in fracs:
        rows.append(("lsb_keep_frac", fr, one(lsb_keep_frac=fr)))
    for fused in (False, True):
        rows.append(("slice_aware_cache", not fused,
                     one(fused_slices=fused)))
    # Prefetching baseline (paper §2.1): flash traffic vs cache-aware.
    rows.append(("prefetch_topk", 4, one(
        policy=RoutingPolicy(kind="topk", slice_mode="highbit"),
        fused_slices=True, warmup="empty", miss_rate_target=None,
        prefetch_top_m=4)))
    return rows


def storage_rows(store):
    """HOBBIT-style duplicated mixed precision vs AMAT Matryoshka storage
    (paper §2.2): bytes per expert to support {high, low} precisions."""
    matryoshka = store.highbit_expert_bytes()
    duplicated = store.highbit_expert_bytes() + store.msb_bytes_per_expert
    return [("storage_per_expert_bytes", "amat_matryoshka",
             round(matryoshka), "", "", ""),
            ("storage_per_expert_bytes", "hobbit_duplicated",
             round(duplicated), "", "", "")]


def main(quick: bool = False, device=None) -> None:
    t0 = time.perf_counter()
    cfg, params = train_or_load(ARCH, device=device)
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (1, PROMPT))
    sink = CsvSink("torch_ablations", HEADER)
    for name, setting, r in run_rows(cfg, params, toks, quick=quick,
                                     device=device):
        sink.add(name, setting, round(r["energy_mj"], 4),
                 round(r["latency_ms"], 4), r["lsb_fetches"],
                 round(r["miss_rate"], 4))
    probe = SliceMoEEngine(cfg, params, EngineConfig(max_seq=96),
                           device=device)
    for row in storage_rows(probe.store):
        sink.add(*row)
    del probe

    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    sliced = [r for r in sink.rows if r[0] == "slice_aware_cache"]
    gain = sliced[1][2] / max(sliced[0][2], 1e-12) if len(sliced) == 2 else 0
    report("torch_ablations", us, f"fused/sliced_energy={gain:.2f}x;csv={path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one theta, one keep fraction")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
