"""Design-space tour on the port (the counterpart of
``examples/compare_policies.py``; imports no JAX): routing x precision x
warmup on one model.

Reproduces the paper's core comparison as a single table, showing how
each SliceMoE component moves decode energy/latency/fidelity:

  topk/highbit/empty        -> naive baseline
  cache_prior/highbit/empty -> Cache-Prior (SOTA baseline)
  cache_prior/lowbit/empty  -> uniform low-bit (accuracy ceiling)
  cache_prior/dbsc/empty    -> + bit-sliced caching  (DBSC+AMAT)
  cache_prior/dbsc/pcw      -> + predictive warmup  (full SliceMoE)

The two *routing* variants run live (routing feeds back into the model,
so each needs its own forward passes, and yields a top-1 fidelity score
against the float oracle), while the precision/warmup axis is swept
**offline** by replaying the full-SliceMoE run's recorded trace under
policy overrides (``repro_torch.sim.autotune``): no extra forward
passes, same cost model, same table.

The model is ``benchmarks/torch_common.train_or_load``'s (cached in
``results/trained_torch/``), or ``--ckpt``: a checkpoint directory that
either package wrote, holding ``{"params": ...}``.  The prompt is a numpy
draw from seed 3.

Run:  PYTHONPATH=src python examples/compare_policies_torch.py
      [--device cpu] [--ckpt DIR]
"""

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import train_or_load  # noqa: E402
from repro_torch.checkpoint import ckpt as CKPT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, SliceMoEEngine  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import decode_step, prefill  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402
from repro_torch.sim import TraceRecorder  # noqa: E402
from repro_torch.sim import autotune as at  # noqa: E402

ARCH = "deepseek-v2-lite-repro"
STEPS = 24

# Offline rows: replay the recorded cache_prior trace under overrides.
REPLAY_CONFIGS = [
    ("cache_prior/highbit/empty",
     {"slice_mode": "highbit", "warmup": "empty", "fused_slices": True}),
    ("cache_prior/lowbit/empty",
     {"slice_mode": "lowbit", "warmup": "empty"}),
    ("cache_prior/dbsc/empty", {"warmup": "empty"}),
    ("cache_prior/dbsc/pcw", {}),        # the recorded run itself
]


def run_live(cfg, params, toks, oracle, cache_bytes, *, kind, mode, warm,
             fused, device, record=False):
    """One live engine run; returns (metrics row, trace | None)."""
    eng = SliceMoEEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=cache_bytes,
        policy=RoutingPolicy(kind=kind, slice_mode=mode),
        miss_rate_target=0.05, warmup=warm, max_seq=96,
        fused_slices=fused), device=device)
    rec = TraceRecorder(eng) if record else None
    lg = eng.prefill(toks)
    first = torch.argmax(lg, dim=-1)
    out, metrics = eng.decode(first, STEPS)
    d = metrics["decode_totals"]
    s = metrics["cache_stats"]
    miss = (s["msb_misses"] + s["lsb_misses"]) / max(
        s["msb_hits"] + s["msb_misses"]
        + s["lsb_hits"] + s["lsb_misses"], 1)
    agree = np.mean([a == b for a, b in zip(out[0].tolist(), oracle)])
    row = {"energy_j": d["total_energy_j"],
           "latency_s": d["total_latency_s"],
           "miss": miss, "top1": agree}
    return row, (rec.trace() if rec is not None else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt", default=None,
                    help="use this checkpoint instead of training")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.ckpt:
        cfg = get_config(ARCH)
        params = CKPT.restore(args.ckpt, dev)["params"]
    else:
        cfg, params = train_or_load(ARCH, device=dev)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 48))

    # float-model oracle trajectory for fidelity
    logits, cache, _ = prefill(params, cfg, torch.as_tensor(toks, device=dev),
                               max_seq=96)
    token = torch.argmax(logits, dim=-1)
    oracle = []
    for _ in range(STEPS):
        oracle.append(int(token[0]))
        logits, cache, _ = decode_step(params, cfg, token, cache)
        token = torch.argmax(logits, dim=-1)

    probe = SliceMoEEngine(cfg, params, EngineConfig(max_seq=96), device=dev)
    cache_bytes = 0.3 * probe.store.total_bytes()
    del probe

    # Live pass 1: the naive baseline (different routing -> must be live).
    naive, _ = run_live(cfg, params, toks, oracle, cache_bytes,
                        kind="topk", mode="highbit", warm="empty",
                        fused=True, device=dev)
    # Live pass 2: full SliceMoE, recorded; the offline rows replay it.
    slicemoe, trace = run_live(cfg, params, toks, oracle, cache_bytes,
                               kind="cache_prior", mode="dbsc",
                               warm="pcw", fused=False, device=dev,
                               record=True)

    print(f"{'config':32s} {'src':>7s} {'energy mJ':>10s} "
          f"{'latency ms':>11s} {'miss%':>6s} {'top1':>5s}")

    def show(name, src, energy_j, latency_s, miss, top1):
        t1 = f"{top1:5.2f}" if top1 is not None else "    -"
        print(f"{name:32s} {src:>7s} {energy_j * 1e3:10.3f} "
              f"{latency_s * 1e3:11.3f} {miss * 100:6.1f} {t1}")

    show("topk/highbit/empty", "live", naive["energy_j"],
         naive["latency_s"], naive["miss"], naive["top1"])
    for name, overrides in REPLAY_CONFIGS:
        r = at.evaluate(trace, overrides, name)
        # The recorded config replays the live run exactly; attach its
        # live top-1 to that row (offline rows change only the cost
        # model, not the tokens, so fidelity is the live run's).
        top1 = slicemoe["top1"] if not overrides else None
        show(name, "replay" if overrides else "rec+sim",
             r.energy_j, r.latency_s, r.miss_rate, top1)
    print("\n('replay' rows are model-free trace replays of the recorded "
          "cache_prior/dbsc/pcw run\n under policy overrides; see "
          "docs/simulation.md for what replay can vary faithfully)")


if __name__ == "__main__":
    main()
