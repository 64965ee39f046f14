"""SLO-controller soak on the port: closed-loop adaptation vs every static
config (the counterpart of ``benchmarks/controller_soak.py``; imports no
JAX).

Drives a phase-shifting multi-tenant workload (tenant mix AND expert
hotness change at every phase boundary —
:func:`repro_torch.sim.synthetic.tenant_phase_trace`) through the
model-free replay under three static configs and under the closed-loop
SLO controller (:mod:`repro_torch.control`), then scores everyone on the
same per-(tenant, phase) SLO grid:

* a cell is **attained** iff the tenant's charged miss rate in that
  phase meets its miss SLO *and* its critical-selection low-bit exposure
  meets its accuracy SLO (``lowbit_frac``);
* **attainment** is the fraction of attained cells.

Acceptance (asserted):

  (a) the controller's attainment is strictly higher than every static
      config's, at equal-or-lower energy than the best static
      (best = highest attainment, ties broken toward lower energy);
  (b) **fidelity**: a *live* 2-tenant serving run with the controller
      enabled records a trace whose bare replay reproduces the live
      per-epoch miss counts exactly and per-step miss/energy curves
      within rtol 1e-6;
  (c) replay determinism: two replays of the controller config agree
      step-for-step.

The soak grid is model-free, so the full run's grid must reproduce the
reference's persisted ``results/BENCH_controller_soak.json`` at rtol
1e-6.  The live run serves the port's ``init_params(cfg, seed=0)`` on
``--device`` (``cuda`` unless told otherwise); the full run's record is
``results/BENCH_torch_controller_soak.json``.

Run:  PYTHONPATH=src python benchmarks/torch_controller_soak.py [--quick]
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

from benchmarks.torch_common import (json_record, reference_record,  # noqa: E402
                                     report)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.control import ControllerConfig, TenantSLO  # noqa: E402
from repro_torch.core.amat import MatConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, PersistentEngine  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.moe import RoutingPolicy  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler, SchedulerConfig)
from repro_torch.serving.workloads import (LengthDist, TenantSpec,  # noqa: E402
                                           WorkloadConfig, generate)
from repro_torch.sim import TraceRecorder, replay_trace  # noqa: E402
from repro_torch.sim.synthetic import (SyntheticSpec,  # noqa: E402
                                       tenant_phase_trace)

ARCH = "qwen15-moe-repro"
LIVE_CACHE_BYTES = 1.0e6

# The SLO grid everyone is judged on (the reference's): premium is
# accuracy-sensitive and pinned at full precision with a loose miss SLO;
# batch tolerates full low-bit service but carries a tight miss SLO.
SLOS = {
    "premium": TenantSLO(miss_rate=0.60, lowbit_frac=0.05,
                         bit_floor="high"),
    "batch": TenantSLO(miss_rate=0.15, lowbit_frac=1.0,
                       bit_floor="low"),
}

STATICS = {
    "static:dbsc": {},
    "static:lowbit": {"slice_mode": "lowbit"},
    "static:highbit": {"slice_mode": "highbit"},
}


def _controller_cfg(interval: int = 4, *,
                    partition: bool = False) -> ControllerConfig:
    # Partitioning is off for the replayed soak (the workload is
    # capacity-starved); the live fidelity run turns it on.
    return ControllerConfig(slos=dict(SLOS), interval=interval,
                            window=32, cooldown=2 * interval,
                            hysteresis=0.1, partition=partition)


def _soak_trace(quick: bool):
    # Mix shifts every phase: batch-heavy -> premium-only -> batch-heavy
    # again, on freshly drawn hotness each time.
    mixes = [{"premium": 1.0, "batch": 3.0},
             {"premium": 1.0},
             {"premium": 1.0, "batch": 3.0}]
    phases = 2 if quick else 3
    return tenant_phase_trace(
        SyntheticSpec(cache_frac=0.35),
        tenants=mixes[:phases], phases=phases,
        requests_per_phase=4 if quick else 8,
        prompt_len=12, decode_steps=12 if quick else 24,
        zipf_a=2.0, seed=0)


# ---------------------------------------------------------------- scoring
def _step_cells(trace):
    """(tenant, phase) per decode event, in trace order."""
    cells = []
    phase, tenant = 0, "default"
    for e in trace.events:
        if e.kind == "prefill":
            if e.label and e.label.startswith("ph"):
                phase = int(e.label.split("/")[0][2:])
            tenant = getattr(e, "tenant", None) or "default"
        else:
            cells.append((tenant, phase))
    return cells


def score(trace, rep) -> dict:
    """Attainment over the per-(tenant, phase) SLO grid."""
    cells = _step_cells(trace)
    rows = rep.per_tenant_rows or []
    assert len(cells) == len(rows), (len(cells), len(rows))
    agg: dict = {}
    for (_, phase), by_tenant in zip(cells, rows):
        for tenant, row in (by_tenant or {}).items():
            c = agg.setdefault((tenant, phase),
                               {"accesses": 0, "misses": 0,
                                "critical": 0, "critical_low": 0})
            for k in c:
                c[k] += int(row.get(k, 0))
    grid = {}
    attained = 0
    for (tenant, phase), c in sorted(agg.items()):
        slo = SLOS[tenant]
        miss = c["misses"] / max(c["accesses"], 1)
        low = c["critical_low"] / max(c["critical"], 1)
        ok = (slo.miss_rate is None or miss <= slo.miss_rate) \
            and low <= slo.lowbit_frac
        attained += ok
        grid[f"{tenant}/ph{phase}"] = {
            "miss_rate": miss, "lowbit_frac": low, "attained": bool(ok)}
    return {
        "attainment": attained / max(len(agg), 1),
        "n_cells": len(agg),
        "energy_j": rep.total_energy_j,
        "latency_s": rep.total_latency_s,
        "decode_miss_rate": rep.decode_miss_rate,
        "grid": grid,
    }


def soak(quick: bool):
    """The replayed soak: (trace, scores by config, the controller's
    report).  Asserts (c), replay determinism."""
    trace = _soak_trace(quick)
    results = {}
    for name, overrides in STATICS.items():
        results[name] = score(trace, replay_trace(trace, **overrides))
    ctl_cfg = _controller_cfg()
    ctl_rep = replay_trace(trace, controller=ctl_cfg)
    results["controller"] = score(trace, ctl_rep)

    # (c) replay determinism: same trace + same controller -> identical
    # curves and identical decisions.
    ctl_rep2 = replay_trace(trace, controller=ctl_cfg)
    assert ctl_rep2.miss_curve == ctl_rep.miss_curve
    assert ctl_rep2.controller_summary == ctl_rep.controller_summary
    return trace, results, ctl_rep


def best_static(results: dict) -> str:
    return max(STATICS, key=lambda n: (results[n]["attainment"],
                                       -results[n]["energy_j"]))


# --------------------------------------------------------- fidelity gate
def _close(a: float, b: float, rtol: float = 1e-6) -> bool:
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _live_fidelity(quick: bool, cfg=None, params=None, device=None,
                   quant_execution: bool = False,
                   cache_bytes: float = LIVE_CACHE_BYTES) -> dict:
    """Record a live controller-enabled 2-tenant serving run on
    ``device`` and assert its bare replay reproduces it (gate (b)).
    ``cfg`` defaults to the 2-layer ``qwen15-moe-repro`` and ``params``
    to its ``init_params(cfg, seed=0)``; ``quant_execution`` runs the
    experts on their packed codes (the batched AMAT kernels on the
    card)."""
    n_requests = 4 if quick else 6
    dev = resolve_device(device)
    if cfg is None:
        cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    ecfg = EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=cache_bytes,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=quant_execution),
        miss_rate_target=0.1, warmup="pcw", max_seq=64,
        controller=_controller_cfg(interval=4, partition=True))
    engine = PersistentEngine(cfg, params, ecfg, device=dev)
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=1, max_queue=n_requests + 1),
        device=dev)
    rec = sched.attach_recorder(TraceRecorder())
    tenants = tuple(
        TenantSpec(name=t, weight=w,
                   prompt_len=LengthDist("fixed", 24),
                   output_len=LengthDist("fixed", 12))
        for t, w in (("premium", 1.0), ("batch", 2.0)))
    for r in generate(WorkloadConfig(kind="closed_loop",
                                     n_requests=n_requests, seed=0,
                                     tenants=tenants), cfg.vocab_size):
        sched.submit(r)
    sched.run()
    live = {
        "miss_curve": sched.telemetry.miss_rate_curve(),
        "energy_curve": sched.telemetry.energy_curve(),
        "epoch_counts": engine.cache.epoch_counts(),
        "ledger": engine.ledger.snapshot(),
        "controller": engine.slo_controller.summary(),
    }

    rep = replay_trace(rec.trace())
    assert rep.epoch_counts == live["epoch_counts"], \
        (rep.epoch_counts, live["epoch_counts"])
    assert rep.miss_curve == live["miss_curve"], "per-step miss drifted"
    assert all(_close(a, b) for a, b in
               zip(rep.energy_curve, live["energy_curve"])), \
        "per-step energy drifted"
    for key in ("total_energy_j", "total_latency_s", "flash_bytes",
                "dram_bytes"):
        assert _close(rep.ledger[key], live["ledger"][key]), key
    ctl = rep.controller_summary
    assert ctl is not None \
        and ctl["levels"] == live["controller"]["levels"] \
        and ctl["budgets"] == live["controller"]["budgets"] \
        and ctl["n_actions"] == live["controller"]["n_actions"], \
        (ctl, live["controller"])
    print(f"fidelity: live controller run == bare replay "
          f"({len(live['miss_curve'])} steps, epochs exact, "
          f"{ctl['n_actions']} controller actions reproduced)")
    return {"n_steps": len(live["miss_curve"]),
            "n_actions": ctl["n_actions"],
            "levels": ctl["levels"]}


def _check_against_baseline(payload: dict, *, quick: bool,
                            rtol: float = 1e-6) -> None:
    """The replayed soak cells are model-free and deterministic: they
    must reproduce the reference's persisted
    ``results/BENCH_controller_soak.json``."""
    prev = None if quick else reference_record("controller_soak")
    if prev is None:
        return
    if prev.get("n_decode_steps") != payload["n_decode_steps"]:
        return                      # different horizon, incomparable
    mismatches = []
    for name, row in prev.get("configs", {}).items():
        cur_row = payload["configs"].get(name)
        for k in ("attainment", "energy_j", "latency_s",
                  "decode_miss_rate"):
            v = row.get(k)
            cur = None if cur_row is None else cur_row.get(k)
            if not isinstance(v, (int, float)):
                continue
            if cur is None or not _close(v, cur, rtol):
                mismatches.append((name, k, v, cur))
    assert not mismatches, \
        f"soak diverged from persisted baseline: {mismatches}"
    print("baseline check: soak cells reproduce the reference's "
          f"BENCH_controller_soak.json (rtol={rtol:g})")


def main(quick: bool = False, device=None) -> None:
    dev = resolve_device(device)
    trace, results, ctl_rep = soak(quick)
    n_steps = trace.n_decode_steps
    print(f"=== controller soak: {trace.meta.model}, "
          f"{trace.n_prefills} requests / {n_steps} decode steps, "
          f"phase-shifting tenant mix ===")

    for name, r in results.items():
        cells = " ".join(
            f"{cell}[{'ok' if v['attained'] else 'VIOL'} "
            f"m={v['miss_rate']:.2f} l={v['lowbit_frac']:.2f}]"
            for cell, v in r["grid"].items())
        print(f"{name:>16}: attainment={r['attainment']:.3f} "
              f"energy={r['energy_j'] * 1e3:.3f} mJ  {cells}")
    ctl_sum = ctl_rep.controller_summary
    print(f"controller actions: {ctl_sum['n_actions']} "
          f"(levels={ctl_sum['levels']}, "
          f"admit={ctl_sum['admit_fracs']})")

    # (a) adaptation beats every static on attainment, at equal-or-lower
    # energy than the best static.
    ctl = results["controller"]
    for name in STATICS:
        assert ctl["attainment"] > results[name]["attainment"], \
            (name, ctl["attainment"], results[name]["attainment"])
    best = best_static(results)
    assert ctl["energy_j"] <= results[best]["energy_j"], \
        (best, ctl["energy_j"], results[best]["energy_j"])
    print(f"claims verified: controller attainment "
          f"{ctl['attainment']:.3f} > best static "
          f"({best}: {results[best]['attainment']:.3f}) at "
          f"{results[best]['energy_j'] / ctl['energy_j']:.2f}x lower "
          f"energy")

    # (b) live-vs-replay fidelity with the controller in the loop.
    print("\n=== live controller serving run vs bare replay ===")
    fidelity = _live_fidelity(quick, device=dev)

    payload = {
        "device": dev.type,
        "dtype": get_config(ARCH).dtype,
        "n_requests": trace.n_prefills,
        "n_decode_steps": n_steps,
        "slos": {t: s.to_dict() for t, s in SLOS.items()},
        "configs": results,
        "best_static": best,
        "controller_actions": ctl_sum["n_actions"],
        "fidelity": fidelity,
    }
    _check_against_baseline(payload, quick=quick)
    if not quick:
        # --quick runs a shorter horizon; its grid is not the record's.
        json_record("controller_soak", payload)
    report("torch_controller_soak", 0.0,
           f"attainment={ctl['attainment']:.3f}"
           f"(best_static={results[best]['attainment']:.3f});"
           f"energy_vs_best={ctl['energy_j'] / results[best]['energy_j']:.3f}x;"
           f"fidelity=exact")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
