"""Serve synthetic traffic through the continuous-batching subsystem on
the port (the counterpart of ``examples/serve_traffic.py``; imports no
JAX).

Phase 1 — briefly train the Qwen1.5-MoE-structure model so routing is
non-degenerate (``benchmarks/torch_common.train_or_load``, cached in
``results/trained_torch/``), or load ``--ckpt``: a checkpoint directory
that either package wrote, holding ``{"params": ...}``.
Phase 2 — generate a seeded traffic scenario (Poisson / bursty /
closed-loop / multi-tenant), push it through the persistent-engine
scheduler, and print the fleet telemetry: latency percentiles,
throughput, energy per token and the warm-up miss-rate curve.

Run:  PYTHONPATH=src python examples/serve_traffic_torch.py \
          [--scenario steady|bursty|closed_loop|multi_tenant] \
          [--requests 8] [--max-batch 4] [--rate 4.0] [--device cpu] \
          [--ckpt DIR]
"""

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402

from benchmarks.torch_common import train_or_load  # noqa: E402
from repro_torch.checkpoint import ckpt as CKPT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, PersistentEngine  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler, SchedulerConfig)
from repro_torch.serving.telemetry import format_summary  # noqa: E402
from repro_torch.serving.workloads import generate, scenario  # noqa: E402

ARCH = "qwen15-moe-repro"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps before serving")
    ap.add_argument("--scenario", default="steady",
                    choices=["steady", "bursty", "closed_loop",
                             "multi_tenant"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrivals per simulated second")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--cache-mb", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt", default=None,
                    help="serve this checkpoint instead of training")
    args = ap.parse_args()

    if args.ckpt:
        print(f"=== phase 1: load {args.ckpt} ===")
        cfg = get_config(ARCH)
        params = CKPT.restore(args.ckpt, args.device)["params"]
    else:
        print("=== phase 1: train ===")
        cfg, params = train_or_load(ARCH, steps=args.steps,
                                    device=args.device)

    print(f"\n=== phase 2: serve '{args.scenario}' traffic ===")
    engine = PersistentEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4),
        cache_bytes=args.cache_mb * 1e6,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
        miss_rate_target=0.10,
        warmup="pcw",
        max_seq=128), device=args.device)
    # truncate_prompts: a traffic demo prefers serving a clipped prompt
    # over rejecting the request (admission is strict by default).
    sched = ContinuousBatchingScheduler(engine, SchedulerConfig(
        max_batch=args.max_batch, max_queue=args.max_queue,
        bucket_prompts=8, truncate_prompts=True), device=args.device)

    wl = scenario(args.scenario, n_requests=args.requests,
                  rate=args.rate, seed=args.seed)
    requests = generate(wl, cfg.vocab_size)
    for r in requests:
        accepted = sched.submit(r)
        if not accepted:
            print(f"  request {r.request_id} rejected (queue full)")

    completions = sched.run()
    for c in completions:
        m = c.metrics
        print(f"  req {c.request_id:3d}: {len(c.tokens):3d} tokens  "
              f"ttft={m['ttft_s']*1e3:7.2f} ms  "
              f"miss={m['mean_miss_rate']:.3f}  "
              f"alpha={m['alpha_final']:.2f}")

    print()
    print(format_summary(sched.summary(),
                         title=f"fleet summary ({args.scenario})"))
    # Per-request stats epochs exist only in single-slot mode (batched
    # decode interleaves requests in one stats window).
    if args.max_batch == 1:
        curve = engine.cache.epoch_miss_rates()
        prefills = [m for label, m in curve
                    if label.endswith("/prefill")]
        print("\nprefill miss-rate per request (cache warming up):")
        print("  " + " ".join(f"{m:.2f}" for m in prefills))


if __name__ == "__main__":
    main()
