"""Offline policy tuning on the port (the counterpart of
``examples/offline_tune.py``; imports no JAX): record a trace, replay
it, read the frontier.

The end-to-end ``repro_torch.sim`` workflow:

Phase 1 — serve a small live workload once, recording its routing trace
          (or skip the model entirely with ``--synthetic``).
Phase 2 — autotune: sweep cache budget x AMAT bit plan x warmup x
          prefetch over the trace with the model-free replay simulator
          (hundreds of configs/sec — no forward passes).
Phase 3 — report the energy/latency/miss Pareto frontier and the
          cheapest config meeting the ``--slo`` decode miss-rate SLO.

The live model is the port's init from seed 0 (the reference draws its
own with ``jax.random``, so the live trace differs from its run); the
synthetic trace is the same seeded stream in both packages.

Run:  PYTHONPATH=src python examples/offline_tune_torch.py [--synthetic]
          [--requests 6] [--slo 0.05] [--halving] [--device cpu]
"""

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import dataclasses  # noqa: E402

from repro_torch.sim import autotune as at  # noqa: E402


def record_live_trace(n_requests: int, device=None):
    """Phase 1a: serve live traffic with a recorder attached."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig, PersistentEngine
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import RoutingPolicy
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)
    from repro_torch.serving.workloads import (LengthDist, TenantSpec,
                                               WorkloadConfig, generate)
    from repro_torch.sim import TraceRecorder

    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2)
    params = init_params(cfg, seed=0, device=device)
    engine = PersistentEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=1.0e6,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
        miss_rate_target=0.1, warmup="pcw", max_seq=64), device=device)
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=1, max_queue=n_requests + 1),
        device=device)
    rec = sched.attach_recorder(TraceRecorder())
    tenant = TenantSpec(prompt_len=LengthDist("fixed", 24),
                        output_len=LengthDist("fixed", 12))
    for r in generate(WorkloadConfig(kind="closed_loop",
                                     n_requests=n_requests, seed=0,
                                     tenants=(tenant,)), cfg.vocab_size):
        sched.submit(r)
    sched.run()
    return rec.trace()


def synthetic_trace(n_requests: int):
    """Phase 1b: no model at all — a seeded Zipf-hotness stream."""
    from repro_torch.sim import SyntheticSpec, zipf_trace

    spec = SyntheticSpec(n_moe_layers=4, n_experts=32, top_k=4,
                         cache_frac=0.2)
    return zipf_trace(spec, n_requests=n_requests, prompt_len=24,
                      decode_steps=24, zipf_a=1.3, seed=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true",
                    help="skip the live model; tune on a synthetic trace")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slo", type=float, default=0.05,
                    help="decode miss-rate SLO for the winner pick")
    ap.add_argument("--halving", action="store_true",
                    help="successive halving instead of full sweeps")
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="also save the trace (.npz / .jsonl)")
    ap.add_argument("--device", default=None,
                    help="torch device of the live model (default: cuda)")
    args = ap.parse_args()

    print("=== phase 1: obtain a routing trace ===")
    if args.synthetic:
        trace = synthetic_trace(args.requests)
    else:
        trace = record_live_trace(args.requests, args.device)
    print(f"trace: {trace.meta.model} — {trace.n_prefills} prefills, "
          f"{trace.n_decode_steps} decode steps, "
          f"default cache {trace.meta.engine['cache_bytes'] / 1e6:.2f} MB")
    if args.save_trace:
        print(f"saved -> {trace.save(args.save_trace)}")

    print("\n=== phase 2: sweep policies over the trace (model-free) ===")
    base_mb = trace.meta.engine["cache_bytes"] / 1e6
    policies = [("default(recorded)", {})]
    policies += [(f"cache={mb:g}MB, {w}",
                  {"cache_bytes": mb * 1e6, "warmup": w})
                 for mb in (2 * base_mb, 4 * base_mb, 6 * base_mb)
                 for w in ("pcw", "empty")]
    policies += [
        (f"cache={4 * base_mb:g}MB, MAT63",
         {"cache_bytes": 4 * base_mb * 1e6,
          "high_bits": 6, "low_bits": 3}),
        (f"cache={4 * base_mb:g}MB, prefetch4",
         {"cache_bytes": 4 * base_mb * 1e6, "prefetch_top_m": 4}),
        (f"cache={4 * base_mb:g}MB, async",
         {"cache_bytes": 4 * base_mb * 1e6, "async_io": True}),
    ]
    results = at.sweep(trace, policies, miss_slo=args.slo,
                       successive_halving=args.halving)

    print("\n=== phase 3: Pareto report ===")
    print(at.format_results(results, miss_slo=args.slo,
                            title="offline tune"))
    default = next(r for r in results if r.name == "default(recorded)")
    best = at.best_under_slo(at.pareto_frontier(results), args.slo)
    if best is None:
        print(f"\nno config met the {args.slo:.0%} miss SLO — "
              "widen the sweep (larger cache / different bit plan)")
        return
    print(f"\ncheapest config meeting miss <= {args.slo:.0%}: "
          f"{best.name}")
    print(f"  miss {best.miss_rate:.3f}, energy "
          f"{best.energy_j * 1e3:.3f} mJ, latency "
          f"{best.latency_s * 1e3:.3f} ms")
    if not default.partial:
        print(f"  vs recorded default: miss {default.miss_rate:.3f}, "
              f"energy {default.energy_j * 1e3:.3f} mJ "
              f"({default.energy_j / best.energy_j:.2f}x more)")


if __name__ == "__main__":
    main()
