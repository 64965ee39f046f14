"""Paper Fig. 8 on the port: accuracy vs high-bit-normalized miss rate
(the counterpart of ``benchmarks/fig8_accuracy.py``; imports no JAX).

The paper's tradeoff: enforcing a miss-rate constraint forces cache-aware
routing to divert tokens away from their preferred experts; schemes that
cache *more* experts under the same byte budget (low-bit, DBSC slices)
need less routing distortion at a given miss target and keep accuracy.

We sweep miss-rate targets x cache budgets for four precision schemes
(high-bit fused / uniform low-bit / AMAT-static / DBSC) and measure:
  * achieved decode miss rate (high-bit-normalized: misses weighted by
    slice bytes relative to a full high-bit expert),
  * fidelity = top-1 agreement of decode logits with the float-model
    no-constraint oracle over the decode trajectory.

The model is ``torch_common.train_or_load``'s; the prompt is drawn with
numpy from seed 7.  The CSV is ``results/bench/torch_fig8_accuracy.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_fig8_accuracy.py [--quick]
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
from repro_torch.models.model import decode_step, prefill  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402

ARCH = "qwen15-moe-repro"
DECODE_STEPS = 24
PROMPT = 48
SCHEMES = ("highbit", "lowbit", "amat_static", "dbsc")
HEADER = ["scheme", "cache_frac", "miss_target", "norm_miss_rate",
          "top1_agreement"]


@torch.no_grad()
def _oracle_trajectory(cfg, params, toks):
    """Greedy decode with float params, no cache constraints."""
    dev = params["embed"].device
    logits, cache, _ = prefill(params, cfg, torch.as_tensor(toks, device=dev),
                               max_seq=96)
    token = torch.argmax(logits, -1)
    traj = []
    for _ in range(DECODE_STEPS):
        traj.append(int(token[0]))
        logits, cache, _ = decode_step(params, cfg, token, cache)
        token = torch.argmax(logits, -1)
    return traj


def _run_scheme(cfg, params, toks, *, mode, cache_bytes, miss_target,
                device=None, quant_execution: bool = False):
    """(decode trajectory, high-bit-normalized miss rate, metrics) of one
    scheme.  ``quant_execution`` runs the experts on their packed codes
    (the batched AMAT kernels on the card); the default dequantizes them
    in plain torch, as the reference does."""
    fused = mode == "highbit"
    ecfg = EngineConfig(
        mat=MatConfig(8, 4),
        cache_bytes=cache_bytes,
        policy=RoutingPolicy(kind="cache_prior", slice_mode=mode,
                             theta=0.5, quant_execution=quant_execution),
        miss_rate_target=miss_target,
        warmup="pcw", max_seq=96, fused_slices=fused)
    eng = SliceMoEEngine(cfg, params, ecfg, device=device)
    logits = eng.prefill(toks)
    out, metrics = eng.decode(torch.argmax(logits, -1), DECODE_STEPS)
    stats = metrics["cache_stats"]
    # high-bit-normalized miss rate: miss bytes / (accesses x high-bit size)
    hb = eng.store.highbit_expert_bytes()
    miss_bytes = (stats["msb_misses"] * (hb if fused
                                         else eng.store.msb_bytes_per_expert)
                  + stats["lsb_misses"] * eng.store.lsb_bytes_per_expert)
    access_bytes = (stats["msb_hits"] + stats["msb_misses"]) * hb
    norm_miss = miss_bytes / max(access_bytes, 1)
    return out[0].tolist(), norm_miss, metrics


def agreement(traj, oracle) -> float:
    """Top-1 agreement of a trajectory with the oracle's."""
    return float(np.mean([a == b for a, b in zip(traj, oracle)]))


def main(quick: bool = False, device=None) -> None:
    t0 = time.perf_counter()
    cfg, params = train_or_load(ARCH, device=device)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, PROMPT))
    oracle = _oracle_trajectory(cfg, params, toks)

    sink = CsvSink("torch_fig8_accuracy", HEADER)

    # cache budgets as fractions of the full high-bit store
    probe = SliceMoEEngine(cfg, params, EngineConfig(max_seq=96),
                           device=device)
    total = probe.store.total_bytes()
    del probe
    fracs = (0.15, 0.3, 0.6) if not quick else (0.3,)
    targets = (0.01, 0.05, 0.2) if not quick else (0.05,)

    best = {}
    for mode in SCHEMES:
        for frac in fracs:
            for tgt in targets:
                traj, miss, _ = _run_scheme(
                    cfg, params, toks, mode=mode,
                    cache_bytes=frac * total, miss_target=tgt, device=device)
                agree = agreement(traj, oracle)
                sink.add(mode, frac, tgt, round(miss, 4), round(agree, 4))
                best[mode] = max(best.get(mode, 0.0), agree)

    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    report("torch_fig8_accuracy", us,
           f"best_top1:dbsc={best.get('dbsc', 0):.2f}"
           f"/highbit={best.get('highbit', 0):.2f};csv={path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one capacity, one miss target")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
