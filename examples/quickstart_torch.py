"""Quickstart on the port (the counterpart of ``examples/quickstart.py``;
imports no JAX): the SliceMoE pipeline in ~60 lines.

Builds a small MoE model, AMAT-quantizes its experts (8-bit codes whose
4-bit MSB slice is free), runs prefill with Predictive Cache Warmup, then
decodes under a 5% miss-rate constraint with Dynamic Bit-Sliced Caching,
printing the simulated DRAM/Flash energy + latency per the paper's Fig. 7
hardware model.  The weights are the port's init from seed 0 and the
prompt a numpy draw from seed 1 (the reference draws both with
``jax.random``, so the numbers differ from its run).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
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

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, SliceMoEEngine  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()

# 1. A DeepSeek-V2-Lite-style MoE (64 experts, top-6, 2 shared experts)
#    at repro scale.
cfg = get_config("deepseek-v2-lite-repro")
params = init_params(cfg, seed=0, device=args.device)
print(f"model: {cfg.name}  layers={cfg.n_layers}  "
      f"experts={cfg.moe.n_experts} top-{cfg.moe.top_k}")

# 2. Engine config: MAT(8,4) Matryoshka experts, a DRAM budget that holds
#    ~30% of the high-bit expert store, Cache-Prior routing with DBSC
#    dynamic precision, 5% miss-rate constraint, PCW warmup.
engine = SliceMoEEngine(cfg, params, EngineConfig(
    mat=MatConfig(8, 4),
    cache_bytes=4e6,
    policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc", theta=0.5),
    miss_rate_target=0.05,
    warmup="pcw",
    max_seq=128,
), device=args.device)
store = engine.store
print(f"expert store: {store.total_bytes() / 1e6:.1f} MB total "
      f"({store.msb_bytes_per_expert / 1e3:.1f} KB msb + "
      f"{store.lsb_bytes_per_expert / 1e3:.1f} KB lsb per expert)")

# 3. Prefill a prompt: expert accesses stream through the cache and the
#    hotness tracker; PCW reshapes the cache at the transition.
prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 64))
logits = engine.prefill(prompt)
print(f"prefill done; warmup: {engine.warmup_summary}")

# 4. Decode 32 tokens under the miss-rate constraint.
first = torch.argmax(logits, dim=-1)
tokens, metrics = engine.decode(first, 32)

d = metrics["decode_totals"]
s = metrics["cache_stats"]
print(f"decoded {tokens.shape[1]} tokens")
print(f"  slice accesses: msb {s['msb_hits']}H/{s['msb_misses']}M   "
      f"lsb {s['lsb_hits']}H/{s['lsb_misses']}M")
print(f"  decode energy:  {d['total_energy_j'] * 1e3:.2f} mJ "
      f"(flash {d['flash_energy_j'] * 1e3:.2f} / "
      f"dram {d['dram_energy_j'] * 1e3:.2f} / "
      f"compute {d['compute_energy_j'] * 1e3:.2f})")
print(f"  decode latency: {d['total_latency_s'] * 1e3:.2f} ms")
print(f"  final cache-prior boost alpha: {engine.alpha:.1f}")
