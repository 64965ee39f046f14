"""Paper Fig. 10 (+Fig. 3) on the port: cache warmup strategies at the
prefill→decode transition, and the prefill-hotness → early-decode
carryover that makes PCW work (the counterpart of
``benchmarks/fig10_warmup.py``; imports no JAX).

Initial states compared: empty / last-layer-only / random / PCW(hot).
Metrics: early-decode energy & latency (first 10 steps, where cold misses
dominate) and whole-decode totals, plus the Spearman-style rank
correlation between prefill expert hotness and early-decode expert usage
(the Fig. 3 observation, reported as `hotness_corr`).  Energy and latency
are the deterministic cost model's.  The model is
``torch_common.train_or_load``'s; the prompt is drawn with numpy from
seed 11.  The CSV is ``results/bench/torch_fig10_warmup.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_fig10_warmup.py [--quick]
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
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import CsvSink, report, train_or_load  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, SliceMoEEngine  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402

ARCH = "deepseek-v2-lite-repro"
DECODE_STEPS = 24
EARLY = 10
PROMPT = 48
INITS = ("empty", "last_layer", "random", "pcw")
HEADER = ["init_state", "early_energy_j", "early_latency_s",
          "total_energy_j", "total_latency_s", "misses", "hotness_corr"]


def run_init(cfg, params, toks, warmup: str, cache_bytes: float, *,
             device=None, quant_execution: bool = False):
    """Early and total decode energy and latency (cost model), misses and
    the hotness rank correlation of one initial cache state.
    ``quant_execution`` runs the experts on their packed codes (the
    batched AMAT kernels on the card); the default dequantizes them in
    plain torch, as the reference does."""
    ecfg = EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=cache_bytes,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=quant_execution),
        miss_rate_target=0.05, warmup=warmup, max_seq=96)
    eng = SliceMoEEngine(cfg, params, ecfg, device=device)

    logits = eng.prefill(toks)
    prefill_hot = eng.tracker.hotness().copy()

    _, metrics = eng.decode(torch.argmax(logits, -1), DECODE_STEPS)
    steps = metrics["per_step"]
    early_e = sum(s["total_energy_j"] for s in steps[:EARLY])
    early_l = sum(s["total_latency_s"] for s in steps[:EARLY])
    tot = metrics["decode_totals"]

    decode_hot = eng.tracker.hotness()
    corr = _rank_corr(prefill_hot.reshape(-1), decode_hot.reshape(-1))
    return dict(early_energy=early_e, early_latency=early_l,
                total_energy=tot["total_energy_j"],
                total_latency=tot["total_latency_s"],
                hotness_corr=corr,
                misses=metrics["cache_stats"]["msb_misses"]
                + metrics["cache_stats"]["lsb_misses"])


def _rank_corr(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / max(denom, 1e-12))


def main(quick: bool = False, device=None) -> None:
    t0 = time.perf_counter()
    cfg, params = train_or_load(ARCH, device=device)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, PROMPT))
    probe = SliceMoEEngine(cfg, params, EngineConfig(max_seq=96),
                           device=device)
    cache_bytes = 0.3 * probe.store.total_bytes()
    del probe

    sink = CsvSink("torch_fig10_warmup", HEADER)
    inits = INITS if not quick else ("empty", "pcw")
    results = {}
    for init in inits:
        r = run_init(cfg, params, toks, init, cache_bytes, device=device)
        results[init] = r
        sink.add(init, f"{r['early_energy']:.5e}",
                 f"{r['early_latency']:.5e}", f"{r['total_energy']:.5e}",
                 f"{r['total_latency']:.5e}", r["misses"],
                 round(r["hotness_corr"], 3))

    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    gain = results["empty"]["early_energy"] / \
        max(results["pcw"]["early_energy"], 1e-12)
    speed = results["empty"]["early_latency"] / \
        max(results["pcw"]["early_latency"], 1e-12)
    report("torch_fig10_warmup", us,
           f"pcw_vs_empty:E{gain:.2f}x/S{speed:.2f}x;"
           f"hotness_corr={results['pcw']['hotness_corr']:.2f};csv={path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="empty and pcw only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
