"""Sim fidelity gate + offline-autotune demonstration on the port (the
counterpart of ``benchmarks/sim_fidelity.py``; imports no JAX).

Records a routing trace from a *live* persistent-engine serving run,
then asserts the three claims that make the trace-driven simulator
(:mod:`repro_torch.sim`) load-bearing:

  (a) **fidelity**: replaying the trace under the recorded config
      reproduces the live run's per-epoch miss counts *exactly* and its
      per-step miss/energy curves and total energy/latency within
      rtol 1e-6;
  (b) **speed**: the model-free replay evaluates >= 100x more decode
      steps/sec than the live engine took on the same trace;
  (c) **autotuning pays**: sweeping cache budget / bit plan / warmup /
      prefetch over the recorded trace yields a Pareto frontier
      containing a config that meets a 5% decode miss-rate SLO at
      measurably lower energy than the recorded default config.

The live runs serve the port's ``init_params(cfg, seed=0)`` on
``--device`` (``cuda`` unless told otherwise).  The reference serves a
JAX init the port cannot draw, so the replay cells are held against the
port's own last full record, ``results/BENCH_torch_sim_fidelity.json``,
when it was made on the same device type at the same size.

Run:  PYTHONPATH=src python benchmarks/torch_sim_fidelity.py [--quick]
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

from benchmarks.torch_common import (BENCH_DIR, json_record,  # noqa: E402
                                     own_record, report)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, PersistentEngine  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler, SchedulerConfig)
from repro_torch.serving.workloads import (LengthDist, TenantSpec,  # noqa: E402
                                           WorkloadConfig, generate)
from repro_torch.sim import (ReplayEngine, Trace, TraceRecorder,  # noqa: E402
                             replay_trace, traces_equal)
from repro_torch.sim import autotune as at  # noqa: E402

ARCH = "qwen15-moe-repro"
PROMPT_LEN = 24
MAX_NEW = 12
CACHE_BYTES = 1.0e6      # deliberately tight: the default misses a lot
MAX_SEQ = 64
MISS_SLO = 0.05


def _engine_cfg(quant_execution: bool = False, **overrides) -> EngineConfig:
    kw = dict(
        mat=MatConfig(8, 4), cache_bytes=CACHE_BYTES,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc"),
        miss_rate_target=0.1, warmup="pcw", max_seq=MAX_SEQ)
    kw.update(overrides)
    if quant_execution:
        kw["policy"] = dataclasses.replace(kw["policy"],
                                           quant_execution=True)
    return EngineConfig(**kw)


def _record_live(cfg, params, n_requests: int, *, device=None,
                 quant_execution: bool = False, **ecfg_overrides):
    """Serve a closed-loop workload live on ``device``, recording its
    routing trace.  ``quant_execution`` runs the experts on their packed
    codes (the batched AMAT kernels on the card)."""
    dev = resolve_device(device)
    engine = PersistentEngine(cfg, params, _engine_cfg(
        quant_execution, **ecfg_overrides), device=dev)
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=1, max_queue=n_requests + 1),
        device=dev)
    rec = sched.attach_recorder(TraceRecorder())
    tenant = TenantSpec(prompt_len=LengthDist("fixed", PROMPT_LEN),
                        output_len=LengthDist("fixed", MAX_NEW))
    reqs = generate(WorkloadConfig(kind="closed_loop",
                                   n_requests=n_requests, seed=0,
                                   tenants=(tenant,)), cfg.vocab_size)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    completions = sched.run()
    wall = time.perf_counter() - t0
    # Decode-only host time (max_batch=1: the per-request decode spans
    # are disjoint and exclude prefill).
    decode_wall = sum(c.decode_s for c in completions)
    live = {
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "energy_curve": sched.telemetry.energy_curve(),
        "epoch_counts": engine.cache.epoch_counts(),
        "per_shard_epoch_counts": (
            engine.cache.per_shard_epoch_counts()
            if hasattr(engine.cache, "per_shard_epoch_counts") else None),
        "ledger": engine.ledger.snapshot(),
        "wall_s": wall,
        "steps_per_s": len(sched.telemetry.steps) / decode_wall,
    }
    return rec.trace(), live


def _close(a: float, b: float, rtol: float = 1e-6) -> bool:
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


# The charge-path gates, each true by construction at any width.
def round_trip(trace, directory: str):
    """The trace through ``.npz`` and ``.jsonl`` under ``directory``:
    both must equal the in-memory trace.  Returns the two loaded."""
    _os.makedirs(directory, exist_ok=True)
    p_npz = trace.save(_os.path.join(directory, "sim_fidelity.npz"))
    p_jsonl = trace.save(_os.path.join(directory, "sim_fidelity.jsonl"))
    t_npz, t_jsonl = Trace.load(p_npz), Trace.load(p_jsonl)
    assert traces_equal(trace, t_npz) and traces_equal(t_npz, t_jsonl), \
        "serialization round trip not exact"
    return t_npz, t_jsonl


def check_fidelity(rep, live) -> None:
    """(a): exact per-epoch miss counts, exact per-step curves,
    energy/latency within rtol 1e-6."""
    assert rep.epoch_counts == live["epoch_counts"], \
        (rep.epoch_counts, live["epoch_counts"])
    assert rep.miss_curve == live["miss_curve"], "per-step miss drifted"
    assert all(_close(a, b) for a, b in
               zip(rep.energy_curve, live["energy_curve"])), \
        "per-step energy drifted"
    for key in ("total_energy_j", "total_latency_s", "flash_bytes",
                "dram_bytes", "compute_ops"):
        assert _close(rep.ledger[key], live["ledger"][key]), \
            (key, rep.ledger[key], live["ledger"][key])


def check_cumsum(cum_trace, cum_live):
    """Cumsum routing's prefill active mask survives the trace; the
    replay equals the live run.  Returns (the first prefill, the
    replay)."""
    pf = next(e for e in cum_trace.events if e.kind == "prefill")
    assert pf.active is not None \
        and not bool(np.asarray(pf.active).all()), \
        "cumsum prefill emitted no deactivated slots"
    cum_rep = replay_trace(cum_trace)
    assert cum_rep.epoch_counts == cum_live["epoch_counts"], \
        (cum_rep.epoch_counts, cum_live["epoch_counts"])
    assert cum_rep.miss_curve == cum_live["miss_curve"]
    for key in ("total_energy_j", "total_latency_s"):
        assert _close(cum_rep.ledger[key], cum_live["ledger"][key]), key
    return pf, cum_rep


def check_ep2(ep_trace, ep_live):
    """ep=2: per-shard miss counts exact, a2a charged.  Returns the
    replay."""
    ep_rep = replay_trace(ep_trace)
    assert ep_rep.per_shard_epoch_counts \
        == ep_live["per_shard_epoch_counts"], "per-shard miss counts drifted"
    for key in ("total_energy_j", "total_latency_s", "ici_bytes",
                "ici_energy_j"):
        assert _close(ep_rep.ledger[key], ep_live["ledger"][key]), key
    assert ep_live["ledger"]["ici_bytes"] > 0, \
        "ep=2 charged no all-to-all traffic"
    return ep_rep


def check_forced_ep1(trace, live) -> None:
    """ep=1 equivalence: the sharded machinery forced onto the recorded
    single-device trace reproduces the live run."""
    forced = ReplayEngine(trace.meta).force_sharded(1)
    forced.consume_all(trace.events)
    frep = forced.finish()
    assert frep.epoch_counts == live["epoch_counts"]
    assert frep.miss_curve == live["miss_curve"]
    for key in ("total_energy_j", "total_latency_s"):
        assert _close(frep.ledger[key], live["ledger"][key]), key


def autotune_policies(scale: float = 1.0):
    """The reference's sweep: cache budget x warmup x bit plan x
    prefetch.  ``scale`` multiplies every cache budget (the names keep
    the reference's)."""
    policies = [("default(recorded)", {})]
    policies += [(f"cache={mb:g}MB{', empty' if w == 'empty' else ''}",
                  {"cache_bytes": mb * 1e6 * scale, "warmup": w})
                 for mb in (2.0, 4.0, 6.5)
                 for w in ("pcw", "empty")]
    policies += [("cache=4MB,MAT63",
                  {"cache_bytes": 4.0e6 * scale, "high_bits": 6,
                   "low_bits": 3}),
                 # Pinned to the Markov baseline, as in the reference.
                 ("cache=4MB,prefetch4",
                  {"cache_bytes": 4.0e6 * scale, "prefetch_top_m": 4,
                   "prefetch_kind": "transition"}),
                 ("cache=4MB,async",
                  {"cache_bytes": 4.0e6 * scale, "async_io": True}),
                 ("cache=4MB,ep2",
                  {"cache_bytes": 4.0e6 * scale, "ep_shards": 2})]
    return policies


def autotune(trace, policies):
    """(results, default row, frontier, best under the SLO or None,
    the sweep's host seconds)."""
    t0 = time.perf_counter()
    results = at.sweep(trace, policies, miss_slo=MISS_SLO)
    sweep_wall = time.perf_counter() - t0
    default = next(r for r in results if r.name == "default(recorded)")
    frontier = at.pareto_frontier(results)
    best = at.best_under_slo(frontier, MISS_SLO)
    return results, default, frontier, best, sweep_wall


def _check_against_baseline(payload: dict, *, quick: bool,
                            rtol: float = 1e-6) -> None:
    """The deterministic replay cells must reproduce the port's last
    record made on the same device type at the same size — sim drift is
    a bug."""
    prev = None if quick else own_record("sim_fidelity")
    if prev is None or prev.get("device") != payload["device"] \
            or prev.get("n_requests") != payload["n_requests"]:
        return                      # other device or size, incomparable
    mismatches = []
    for section in ("default_replay", "best_under_slo", "cumsum_replay",
                    "ep2_replay"):
        for k, v in prev.get(section, {}).items():
            cur = payload[section].get(k)
            if isinstance(v, (int, float)) and (
                    cur is None or not _close(v, cur, rtol)):
                mismatches.append((section, k, v, cur))
    assert not mismatches, \
        f"replay diverged from persisted baseline: {mismatches}"
    print(f"baseline check: replay cells reproduce the last "
          f"BENCH_torch_sim_fidelity.json (rtol={rtol:g})")


def main(quick: bool = False, device=None) -> None:
    dev = resolve_device(device)
    n_requests = 4 if quick else 8

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg, seed=0, device=dev)

    print(f"=== record live serving run: {ARCH} (2 layers), "
          f"{n_requests} requests ===")
    trace, live = _record_live(cfg, params, n_requests, device=dev)
    print(f"recorded {trace.n_prefills} prefills + "
          f"{trace.n_decode_steps} decode steps; "
          f"live {live['steps_per_s']:.1f} decode steps/s")

    # --- (de)serialization round trip: npz and jsonl must agree with
    # the in-memory trace and with each other, and replay identically.
    t_npz, _ = round_trip(trace, BENCH_DIR)

    # --- fidelity gate (acceptance) (a).
    rep = replay_trace(t_npz)
    check_fidelity(rep, live)
    print(f"fidelity: replay == live (epochs exact, "
          f"energy {rep.total_energy_j * 1e3:.3f} mJ, "
          f"latency {rep.total_latency_s * 1e3:.3f} ms, rtol<=1e-6)")

    # --- replay throughput (acceptance (b): >= 100x live).  Best-of-3.
    replay_sps = max([rep.steps_per_s] +
                     [replay_trace(t_npz).steps_per_s for _ in range(2)])
    ratio = replay_sps / live["steps_per_s"]
    print(f"throughput: replay {replay_sps:.0f} steps/s vs live "
          f"{live['steps_per_s']:.1f} steps/s = {ratio:.0f}x")
    assert ratio >= 100.0, \
        f"replay only {ratio:.1f}x live (acceptance needs >= 100x)"

    # --- charge-path variant gates: cumsum's prefill active mask and EP
    # sharding keep live and simulated accounting identical.
    n_small = 2 if quick else 3

    print("\n=== cumsum-routing fidelity (prefill active mask) ===")
    cum_trace, cum_live = _record_live(
        cfg, params, n_small, device=dev,
        policy=RoutingPolicy(kind="cumsum", slice_mode="dbsc",
                             cumsum_tau=0.05, cumsum_kmax=8))
    pf, cum_rep = check_cumsum(cum_trace, cum_live)
    print(f"cumsum: prefill active frac "
          f"{float(np.asarray(pf.active).mean()):.3f}; replay == live "
          f"(epochs exact)")

    print("\n=== expert-parallel fidelity: ep=2 live vs replay, "
          "ep=1 sharded == single-device ===")
    ep_trace, ep_live = _record_live(cfg, params, n_small, device=dev,
                                     ep_shards=2, async_io=True)
    ep_rep = check_ep2(ep_trace, ep_live)
    print(f"ep=2: per-shard miss counts exact over both shards; "
          f"a2a {ep_live['ledger']['ici_bytes']/1e3:.1f} kB charged")

    check_forced_ep1(t_npz, live)
    print("ep=1: sharded engine reproduces the single-device run "
          "exactly (epochs exact, energy/latency rtol<=1e-6)")

    # --- autotune (c): the frontier must contain a config that meets
    # the 5% decode-miss SLO at lower energy than the default.
    results, default, frontier, best, sweep_wall = autotune(
        t_npz, autotune_policies())
    print()
    print(at.format_results(results, miss_slo=MISS_SLO,
                            title=f"autotune sweep ({len(results)} "
                                  f"configs in {sweep_wall:.2f}s)"))
    assert best is not None, \
        f"no swept config met the {MISS_SLO:.0%} miss SLO"
    assert best.energy_j < 0.999 * default.energy_j, \
        (best.energy_j, default.energy_j)
    print(f"\nSLO winner: {best.name} — miss "
          f"{best.miss_rate:.3f} <= {MISS_SLO}, energy "
          f"{best.energy_j * 1e3:.3f} mJ vs default "
          f"{default.energy_j * 1e3:.3f} mJ "
          f"({default.energy_j / best.energy_j:.2f}x cheaper)")

    payload = {
        "arch": ARCH, "device": dev.type, "dtype": cfg.dtype,
        "n_requests": n_requests,
        "n_events": len(t_npz),
        "default_replay": {
            "miss_rate": default.miss_rate,
            "energy_j": default.energy_j,
            "latency_s": default.latency_s,
        },
        "best_under_slo": {
            "name": best.name,
            "miss_rate": best.miss_rate,
            "energy_j": best.energy_j,
            "latency_s": best.latency_s,
        },
        "cumsum_replay": {
            "miss_rate": cum_rep.decode_miss_rate,
            "energy_j": cum_rep.total_energy_j,
            "latency_s": cum_rep.total_latency_s,
        },
        "ep2_replay": {
            "miss_rate": ep_rep.decode_miss_rate,
            "energy_j": ep_rep.total_energy_j,
            "latency_s": ep_rep.total_latency_s,
            "ici_bytes": ep_rep.ledger["ici_bytes"],
        },
        "pareto": [r.name for r in frontier],
        "replay_speedup_x": ratio,
        "sweep_wall_s": sweep_wall,
    }
    _check_against_baseline(payload, quick=quick)
    if not quick:
        json_record("sim_fidelity", payload)
    report("torch_sim_fidelity", 0.0,
           f"replay_speedup={ratio:.0f}x;"
           f"slo_energy_saving={default.energy_j / best.energy_j:.2f}x;"
           f"fidelity=exact")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
