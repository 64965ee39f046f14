"""One run of one cell: set-up, the measured window, the traced segment,
the metrics and the check of what the window served.

The benchmark's description is data: ``BENCHMARK.json`` at the root names
each cell's configuration and traffic mix, and each metric and the cells
it is reported in; ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json``, ``portbench/checks/<cell>.json``
and ``portbench/metrics/<metric>.py`` hold the rest, found by name.  A
configuration's layers are its model module's, ``portbench/models/
<model>.py``, named by the configuration file's ``"model"`` key
(``portbench.lib.loader``): the program's config, the weight draw, the
plain reference's layer loop, the routing records' layout and the
non-expert work counts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import counts as C
from portbench.lib import loader
from portbench.lib.traffic import Mix

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


# --------------------------------------------------------------------- spec
@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    engine: dict
    mix: Mix
    check: dict
    chips: int
    metrics: Dict[bool, List[dict]]      # trace flag -> metric entries
    model: ModuleType                    # the configuration's model module


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _json(root / conf["file"])
    model = loader.model_module(cfg, conf["file"], root)
    engine = _json((root / conf["file"]).parent / cfg["engine"])
    mix = Mix.from_json(_json(HERE / "traffic" / f"{w['traffic']}.json"))
    check = _json(HERE / "checks" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    layer = [m for m in bench["per_layer"] if _listed(m, name)]
    return Cell(name, cfg, engine, mix, check, int(w["chips"]),
                {False: e2e, True: layer}, model)


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    seconds: float
    setup_s: float
    t_open: float
    t_close: float
    d_open: int                   # first decode step of the window
    d_close: int                  # one past the last
    step_end: List[float]
    wall_step_s: List[float]
    wall_prefill_s: List[float]
    decodes: list                 # serve.DecodeRec
    prefills: list                # serve.PrefillRec
    trace: Optional[object] = None   # profile.Trace
    traced_decodes: tuple = (0, 0)
    traced_prefills: tuple = (0, 0)

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def model(self) -> ModuleType:
        return self.cell.model

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def window_decodes(self) -> range:
        return range(self.d_open, self.d_close)

    def window_prefills(self) -> List[int]:
        return [i for i, p in enumerate(self.prefills)
                if self.d_open <= p.step < self.d_close]

    def mat_bits(self):
        m = self.cell.engine["mat"]
        return m["high_bits"], m["low_bits"]

    def decode_work(self, k: int) -> C.Work:
        r = self.decodes[k]
        return C.decode_work(self.cfg, r.ids, r.active, r.critical,
                             r.slot_mask, [v[1] for v in r.slots.values()],
                             self.mat_bits(), model=self.model)

    def prefill_work(self, i: int) -> C.Work:
        p = self.prefills[i]
        return C.prefill_work(self.cfg, p.ids, p.active, p.n_tokens,
                              self.mat_bits(), model=self.model)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_window(cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
    """Set-up, the window and (with ``trace``) the traced segment.
    Returns ``(run, state, peak)``: ``state`` holds the program's objects,
    ``peak`` the device's peak allocation in the window."""
    import torch

    from portbench.lib import serve

    engine, sched, probe, loop = serve.build(cell.cfg, cell.engine,
                                             cell.mix, seed, device,
                                             cell.model)
    t_warm = time.perf_counter()
    for _ in range(cell.mix.warmup_steps):
        loop.step()
    _sync(device)
    # What set-up made lives to the end: keep the collector off it.
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        # The peak reported is the serving peak: set-up holds the float
        # weights and the codes at once for a while, the window does not.
        print("setup: peak "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB",
              file=sys.stderr)
        torch.cuda.reset_peak_memory_stats(device)
    t_open = time.perf_counter()
    print(f"setup: warm-up {t_open - t_warm:.3f} s, process "
          f"{t_open - t_start:.3f} s", file=sys.stderr)
    d_open = len(loop.step_end)
    while True:
        t = loop.step()
        if t - t_open >= seconds:
            break
    run = Run(cell=cell, seconds=seconds, setup_s=t_open - t_start,
              t_open=t_open, t_close=t, d_open=d_open,
              d_close=len(loop.step_end), step_end=loop.step_end,
              wall_step_s=sched.wall_step_s,
              wall_prefill_s=sched.wall_prefill_s,
              decodes=probe.decodes, prefills=probe.prefills)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if trace:
        from portbench.lib.profile import trace_steps

        n_dec, n_pre = len(probe.decodes), len(probe.prefills)
        path = str(ROOT / "build" / "portbench" / f"{cell.name}.trace.json")
        run.trace = trace_steps(loop, cell.mix.trace_steps, path, device)
        run.traced_decodes = (n_dec, len(probe.decodes))
        run.traced_prefills = (n_pre, len(probe.prefills))
        tr, n_win = run.trace, run.d_close - run.d_open
        med = np.median([run.wall_step_s[k]
                         for k in range(*run.traced_decodes)])
        print(f"traced: {cell.mix.trace_steps} steps in {tr.window_s:.3f} s "
              f"({tr.window_s / cell.mix.trace_steps:.4f} s a step against "
              f"the window's {run.window_s / n_win:.4f}), decode step "
              f"median {med:.4f} s, {run.traced_prefills[1] - n_pre} "
              f"prefills, device busy {tr.busy_s():.3f} s", file=sys.stderr)
    ps = run.window_prefills()
    ks = run.window_decodes()
    print(f"window: {run.window_s:.3f} s, {len(ks)} decode steps "
          f"(median {np.median([run.wall_step_s[k] for k in ks]):.4f} s), "
          f"{len(ps)} prefills (median "
          f"{np.median([run.wall_prefill_s[i] for i in ps] or [0]):.4f} s, "
          f"{sum(run.prefills[i].n_tokens for i in ps)} tokens), peak "
          f"{peak / 1e9:.2f} GB", file=sys.stderr)
    state = {"engine": engine, "sched": sched, "probe": probe, "loop": loop}
    return run, state, peak


# ------------------------------------------------------------------- check
def _host_records(run: Run) -> None:
    """Bring the probes' device tensors to the host."""
    for rec in run.prefills + run.decodes:
        for name in ("finite", "t0", "token"):
            if hasattr(rec, name):
                setattr(rec, name, getattr(rec, name).cpu().numpy())


class Served:
    """The window's requests, from the probes and the completions."""

    def __init__(self, run: Run, loop):
        self.run = run
        self.prompts, self.max_new = loop.prompts, loop.max_new
        self.finished = {rid: (step, toks)
                         for rid, (step, toks) in loop.finished.items()
                         if step < run.d_close}
        self.prefill_of = {p.request_id: i
                           for i, p in enumerate(run.prefills)}

    def attempted_failed(self):
        run = self.run
        admitted = [p for p in run.prefills if p.step < run.d_close]
        bad = set()
        for p in admitted:
            if not bool(p.finite.all()):
                bad.add(p.request_id)
        for k in range(run.d_close):
            r = run.decodes[k]
            for slot, (rid, _) in r.slots.items():
                if not bool(r.finite[slot]):
                    bad.add(rid)
        for rid, (_, toks) in self.finished.items():
            if len(toks) != self.max_new[rid]:
                bad.add(rid)
        return len(admitted), len(bad)

    def sample(self, n: int, seed: int) -> List[int]:
        cands = sorted(self.finished)
        if not cands:
            return []
        longest = max(cands, key=lambda r: (len(self.finished[r][1]),
                                            len(self.prompts[r]), -r))
        rest = [r for r in cands if r != longest]
        rng = np.random.default_rng([seed % 2 ** 63, 7])
        pick = rng.choice(len(rest), size=min(n - 1, len(rest)),
                          replace=False) if rest and n > 1 else []
        return [longest] + [rest[int(i)] for i in sorted(pick)]

    def ref_request(self, rid: int):
        """The reference's view of request ``rid`` and the tokens to
        judge, or a reason why its records do not hold together."""
        from portbench.lib.reference import DecodeContext, RefRequest

        run, cfg = self.run, self.run.cfg
        p = run.prefills[self.prefill_of[rid]]
        toks = np.asarray(self.finished[rid][1], np.int64)
        t0 = int(np.asarray(p.t0).reshape(-1)[0])
        fed = np.concatenate([[t0], toks[:-1]]).astype(np.int64)
        layout = tuple(run.model.moe_layout(cfg))
        E = cfg["moe"]["n_experts"]
        ctxs = []
        for j, tok in enumerate(fed):
            r = run.decodes[p.step + j]
            slot = [s for s, (q, _) in r.slots.items() if q == rid]
            if len(slot) != 1 or int(r.token[slot[0]]) != int(tok):
                return None, None, f"request {rid}: decode step " \
                    f"{p.step + j} does not feed its token"
            ctxs.append(DecodeContext(
                cached=r.cached.reshape(layout + (E,)), alpha=r.alpha,
                ids=r.ids.astype(np.int64), active=r.active,
                critical=r.critical, slot_mask=r.slot_mask, slot=slot[0]))
        chosen = np.concatenate([[t0], toks])
        return RefRequest(self.prompts[rid], fed, ctxs), chosen, None


def replay_alpha(run: Run, target: float) -> int:
    """Decode steps whose Cache-Prior boost differs from a plain replay of
    the per-request miss-rate controllers (a frozen copy of the engine's
    PI rule) fed with the step's per-slot miss rates."""
    ctl: Dict[int, PIController] = {}
    first = {p.request_id: p.step for p in run.prefills}
    wrong = 0
    for k in range(run.d_close):
        r = run.decodes[k]
        for slot, (rid, _) in r.slots.items():
            if first.get(rid) == k:
                ctl[rid] = PIController(target)
        alphas = [ctl[r.slots[s][0]].alpha for s in sorted(r.slots)]
        want = float(np.float32(float(np.mean(alphas))))
        wrong += want != r.alpha
        for slot, (rid, _) in r.slots.items():
            ctl[rid].update(float(r.per_slot_miss[slot]))
    return wrong


class PIController:
    """The per-request Cache-Prior controller's rule: proportional-
    integral on the rolling slice miss rate, after 10 warm-up steps."""

    def __init__(self, target: float, kp: float = 40.0, ki: float = 4.0,
                 alpha_max: float = 50.0, warmup: int = 10,
                 window: int = 16):
        self.target, self.kp, self.ki = target, kp, ki
        self.alpha_max, self.warmup, self.window = alpha_max, warmup, window
        self.alpha, self.integral, self.hist, self.n = 0.0, 0.0, [], 0

    def update(self, miss: float) -> None:
        self.n += 1
        self.hist.append(miss)
        if len(self.hist) > self.window:
            self.hist.pop(0)
        if self.n <= self.warmup:
            return
        err = sum(self.hist) / len(self.hist) - self.target
        self.integral = max(0.0, self.integral + err)
        self.alpha = float(min(self.alpha_max, max(
            0.0, self.kp * err + self.ki * self.integral)))


def over_budget(run: Run) -> int:
    """Decode steps whose resident slices outgrow the cache's budget."""
    from portbench.lib.serve import slice_bytes, store_bytes

    eng = run.cell.engine
    msb, lsb = slice_bytes(run.cfg, eng)
    budget = store_bytes(run.cfg, eng, run.model) * eng["cache_fraction"]
    return sum(int(r.cached.sum()) * msb + r.n_lsb * lsb
               > budget * (1 + 1e-9) for r in run.decodes[:run.d_close])


def check(run: Run, served: Served, seed: int, device,
          control: bool = False, detail: bool = False) -> dict:
    """The served tokens against the plain reference, after the program's
    state is gone.  Returns the numbers compared, each with its limit
    (None where the cell compares it not).  ``control`` adds the same
    readings for the tokens that the reference computed in float8 would
    choose (the benchmark's runs leave it out); ``detail`` adds how many
    served tokens lie more than 1, 1.5, ... 4 below the reference's best.

    ``big_gaps`` counts the served tokens whose logit lies more than the
    cell's ``big_gap`` below the reference's best.  A routing flip at a
    near-tie moves a token by less; a token altered where it is produced
    lies far below, and is too rare to move the mean."""
    import torch

    from portbench.lib.reference import logit_gaps

    lim = run.cell.check
    theta = run.cell.engine["policy"]["theta"]
    model = run.model
    ids = served.sample(int(lim["sample_requests"]), seed)
    weights = model.make_weights(run.cfg, seed, device)
    gaps, ctl_gaps, flips, broken = [], [], [], 0 if ids else 1
    for rid in ids:
        req, chosen, why = served.ref_request(rid)
        if req is None:
            print(f"check: {why}", file=sys.stderr)
            broken += 1
            continue
        fl = np.zeros(len(req.fed), np.int64) if control else None
        logits = model.served_logits(run.cfg, weights, req, theta=theta,
                                     flips=fl)
        if control:
            flips.append(np.concatenate([[0], fl]))
        gaps.append(logit_gaps(logits, torch.as_tensor(
            chosen, device=logits.device)).cpu().numpy())
        if control:
            low = model.served_logits(run.cfg, weights, req, fp8=True,
                                      theta=theta)
            ctl_gaps.append(logit_gaps(logits, low.argmax(dim=-1))
                            .cpu().numpy())
            del low
        del logits
    del weights
    if device.type == "cuda":
        torch.cuda.empty_cache()
    g = np.concatenate(gaps) if gaps else np.zeros(1)
    out = {"logit_gap": {"value": float(g.max()),
                         "limit": lim["max_logit_gap"]},
           "mean_logit_gap": {"value": float(g.mean()),
                              "limit": lim["mean_logit_gap"]},
           "tokens_judged": {"value": int(sum(map(len, gaps))),
                             "limit": None}}
    if lim.get("big_gap") is not None:
        out["big_gaps"] = {"value": int((g > lim["big_gap"]).sum()),
                           "limit": lim["max_big_gaps"]}
    if detail:
        for t in (1.0, 1.5, 2.0, 2.5, 3.0, 4.0):
            out[f"gaps_over_{t}"] = {"value": int((g > t).sum()),
                                     "limit": None}
    if control:
        c = np.concatenate(ctl_gaps) if ctl_gaps else np.zeros(1)
        out["control_logit_gap"] = {"value": float(c.max()), "limit": None}
        out["control_mean_logit_gap"] = {"value": float(c.mean()),
                                         "limit": None}
        # Where the reference routes a token as the program did in every
        # layer, and where it does not.
        f = np.concatenate(flips) if flips else np.zeros(1, np.int64)
        for name, sel in (("same_routing", f == 0), ("other_routing", f > 0)):
            out[f"{name}_tokens"] = {"value": int(sel.sum()), "limit": None}
            out[f"{name}_logit_gap"] = {
                "value": float(g[sel].max()) if sel.any() else 0.0,
                "limit": None}
            out[f"{name}_mean_logit_gap"] = {
                "value": float(g[sel].mean()) if sel.any() else 0.0,
                "limit": None}
    out["records_broken"] = {"value": broken, "limit": 0}
    out["alpha_replay_wrong"] = {
        "value": replay_alpha(run, run.cell.engine["miss_rate_target"]),
        "limit": 0}
    out["steps_over_budget"] = {"value": over_budget(run), "limit": 0}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values()
               if c["limit"] is not None)


def loaded_banned() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


# -------------------------------------------------------------------- entry
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False,
             detail: bool = False) -> dict:
    """One run; returns the result line's object (``correct`` and all)."""
    import torch

    run, state, peak = serve_window(cell, seed, seconds, trace, device,
                                    t_start)
    served = Served(run, state["loop"])
    _host_records(run)
    attempted, failed = served.attempted_failed()
    metrics = {}
    for m in cell.metrics[trace]:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    gc.unfreeze()
    state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(run, served, seed, device, control, detail)
    print(f"check: reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    banned = loaded_banned()
    result = {"correct": passed(checks) and failed == 0 and not banned,
              "attempted": attempted, "failed": failed, "metrics": metrics}
    if device.type == "cuda":
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["banned_modules"] = banned
    result["checks"] = checks
    return result
