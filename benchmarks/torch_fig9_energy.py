"""Paper Fig. 9 on the port: decode-stage energy gain & speed-up across
routing/caching schemes at three cache capacities, on both eval models
(the counterpart of ``benchmarks/fig9_energy.py``; imports no JAX).

Schemes (matched to the paper's comparison):
  cache_prior_highbit — SOTA baseline: Cache-Prior routing, whole high-bit
                        experts in an LRU cache,
  buddy_highbit       — BuddyMoE: a missed expert runs as its cached buddy,
  prefetch_highbit    — layer-transition expert prefetch (top-4),
  cumsum              — cumulative-threshold routing (accuracy-first,
                        locality-blind),
  dbsc                — bit-sliced caching + AMAT, no warmup,
  dbsc_pcw            — + predictive cache warmup.

Reported: decode-stage energy (J) and latency (s) from the deterministic
cost model (Fig. 7 constants), normalized per model to the Cache-Prior
high-bit baseline.  The models are ``torch_common.train_or_load``'s
(trained by the port, cached in ``results/trained_torch/``); the prompt
is drawn with numpy from seed 9.  The CSV is
``results/bench/torch_fig9_energy.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_fig9_energy.py [--quick]
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

MODELS = ("deepseek-v2-lite-repro", "qwen15-moe-repro")
DECODE_STEPS = 24
PROMPT = 48

SCHEMES = {
    "cache_prior_highbit": dict(
        policy=RoutingPolicy(kind="cache_prior", slice_mode="highbit"),
        fused_slices=True, warmup="empty"),
    "buddy_highbit": dict(
        policy=RoutingPolicy(kind="buddy", slice_mode="highbit"),
        fused_slices=True, warmup="empty"),
    "prefetch_highbit": dict(
        policy=RoutingPolicy(kind="topk", slice_mode="highbit"),
        fused_slices=True, warmup="empty", prefetch_top_m=4),
    "cumsum": dict(
        policy=RoutingPolicy(kind="cumsum", slice_mode="highbit",
                             cumsum_tau=0.9),
        fused_slices=True, warmup="empty"),
    "dbsc": dict(
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
        fused_slices=False, warmup="empty"),
    "dbsc_pcw": dict(
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
        fused_slices=False, warmup="pcw"),
}


def run_one(cfg, params, toks, cache_bytes, scheme_kw, device=None, *,
            quant_execution: bool = False):
    """(decode energy J, decode latency s, MSB misses) of one scheme:
    prefill ``toks`` [1, S], then ``DECODE_STEPS`` greedy steps.
    ``quant_execution`` runs the experts on their packed codes (the
    batched AMAT kernels on the card); the default dequantizes them in
    plain torch, as the reference does."""
    if quant_execution:
        scheme_kw = dict(scheme_kw, policy=dataclasses.replace(
            scheme_kw["policy"], quant_execution=True))
    ecfg = EngineConfig(mat=MatConfig(8, 4), cache_bytes=cache_bytes,
                        miss_rate_target=0.05, max_seq=96, **scheme_kw)
    eng = SliceMoEEngine(cfg, params, ecfg, device=device)
    logits = eng.prefill(toks)
    _, metrics = eng.decode(torch.argmax(logits, -1), DECODE_STEPS)
    d = metrics["decode_totals"]
    return d["total_energy_j"], d["total_latency_s"], \
        metrics["cache_stats"]["msb_misses"]


def main(quick: bool = False, device=None) -> None:
    t0 = time.perf_counter()
    sink = CsvSink("torch_fig9_energy",
                   ["model", "cache_frac", "scheme", "energy_j",
                    "latency_s", "msb_misses", "energy_gain_vs_highbit",
                    "speedup_vs_highbit"])
    models = MODELS if not quick else MODELS[:1]
    fracs = (0.15, 0.3, 0.6) if not quick else (0.3,)
    headline = []

    for arch in models:
        cfg, params = train_or_load(arch, device=device)
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                 (1, PROMPT))
        probe = SliceMoEEngine(cfg, params, EngineConfig(max_seq=96),
                               device=device)
        total = probe.store.total_bytes()
        del probe
        for frac in fracs:
            results = {name: run_one(cfg, params, toks, frac * total, kw,
                                     device=device)
                       for name, kw in SCHEMES.items()}
            e_ref, l_ref, _ = results["cache_prior_highbit"]
            for name, (e, lat, miss) in results.items():
                sink.add(arch, frac, name, f"{e:.5e}", f"{lat:.5e}", miss,
                         round(e_ref / max(e, 1e-12), 3),
                         round(l_ref / max(lat, 1e-12), 3))
            e_d, l_d, _ = results["dbsc_pcw"]
            headline.append((arch, e_ref / max(e_d, 1e-12),
                             l_ref / max(l_d, 1e-12)))

    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    h = ";".join(f"{a}:E{g:.2f}x/S{s:.2f}x" for a, g, s in headline[:2])
    report("torch_fig9_energy", us, h + f";csv={path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one model, one capacity")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
