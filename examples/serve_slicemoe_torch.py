"""End-to-end example on the port (the counterpart of
``examples/serve_slicemoe.py``; imports no JAX): train a small MoE, then
SERVE requests through the full SliceMoE pipeline.

Phase 1 — train the Qwen1.5-MoE-structure model (60 experts, top-4,
4 shared) on the synthetic zipf-markov stream until routing is
non-degenerate (``benchmarks/torch_common.train_or_load``, cached in
``results/trained_torch/``), or load ``--ckpt``: a checkpoint directory
that either package wrote, holding ``{"params": ...}``.
Phase 2 — serve the requests single-batch (paper Fig. 1a): per request
prefill -> PCW -> miss-rate-constrained DBSC decode; print per-request
tokens, wall time and simulated energy/latency.

Run:  PYTHONPATH=src python examples/serve_slicemoe_torch.py [--steps 60]
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

from benchmarks.torch_common import train_or_load  # noqa: E402
from repro_torch.checkpoint import ckpt as CKPT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.cache import CacheStats  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402
from repro_torch.serving.server import Request, SliceMoEServer  # noqa: E402

ARCH = "qwen15-moe-repro"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps before serving")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-mb", type=float, default=4.0)
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

    print("\n=== phase 2: serve ===")
    server = SliceMoEServer(
        cfg, params,
        engine_cfg=EngineConfig(
            mat=MatConfig(8, 4),
            cache_bytes=args.cache_mb * 1e6,
            policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
            miss_rate_target=0.05,
            warmup="pcw"),
        max_seq=args.prompt_len + args.max_new + 8, device=args.device)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        server.submit(Request(
            request_id=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))

    for c in server.run():
        d = c.metrics["decode_totals"]
        miss = CacheStats(**c.metrics["cache_stats"]).miss_rate
        print(f"request {c.request_id}: {len(c.tokens)} tokens  "
              f"wall prefill {c.prefill_s:.2f}s decode {c.decode_s:.2f}s  |"
              f"  sim: {d['total_energy_j'] * 1e3:.2f} mJ, "
              f"{d['total_latency_s'] * 1e3:.2f} ms, "
              f"slice miss-rate {miss:.1%}")
        print(f"  tokens: {c.tokens[:12].tolist()}...")


if __name__ == "__main__":
    main()
