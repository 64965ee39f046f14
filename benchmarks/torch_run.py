"""Sweep runner of the port's benchmarks (the counterpart of
``benchmarks/run.py``; imports no JAX).

``python -m benchmarks.torch_run [--quick] [--only NAME] [--inline]
[--compare] [--device DEV]``

Each benchmark runs in its own subprocess (one process per model keeps
device and host memory bounded).  ``--only`` executes one benchmark
inline.  Prints one ``name,us_per_call,derived`` CSV line per benchmark;
detailed CSVs land in ``results/bench/``, and ``torch_kernels_micro``,
``torch_sim_fidelity`` and ``torch_controller_soak`` also persist their
records as ``results/BENCH_torch_<name>.json``.  ``--device`` is passed
to every benchmark (default: each one's own, ``cuda``).

``--compare`` is the regression mode: it re-runs every benchmark that
has a persisted ``BENCH_torch_*.json`` baseline (in ``results/``, never
the reference's ``BENCH_*.json``) into a scratch results dir (via
``REPRO_RESULTS_DIR``) and recursively diffs every numeric leaf of the
fresh payload against the baseline, with the reference's leaf policy
(``COMPARE_SKIP``, ``COMPARE_RTOL``, ``_leaf_rtol``, ``_diff_payload``,
verbatim).  A baseline holds the device it was made on; it compares
only on a run on that device type (``torch_kernels_micro``'s on the
card, ``torch_sim_fidelity``'s and ``torch_controller_soak``'s on the
CPU), and the others are listed as not comparable.
``torch_serving_load`` persists no record (it stops at the reference's
calibrated gate, ``benchmarks/serving_load.py:514``), so ``--compare``
has nothing to hold it to.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

BENCH_NAMES = ["torch_table1_amat", "torch_fig8_accuracy",
               "torch_fig9_energy", "torch_fig10_warmup", "torch_ablations",
               "torch_roofline", "torch_kernels_micro",
               "torch_serving_load", "torch_sim_fidelity",
               "torch_controller_soak"]

REPO_ROOT = os.path.abspath(_root)
REPO_RESULTS = os.path.join(REPO_ROOT, "results")

# --compare leaf policy.  Skip-list: substring match on the leaf key for
# metrics that measure *host* wall time (nondeterministic on a shared
# CI box).  Tolerance table: substring-matched relative tolerance, first
# match wins; the "" entry is the default for every simulated metric.
COMPARE_SKIP = ("_us", "wall", "speedup", "steps_per_s")
COMPARE_RTOL = (
    ("bytes", 0.0),        # traffic counters are exact integer counts
    ("", 1e-6),
)

_MISSING = object()


def _leaf_rtol(key: str):
    """None => skip this leaf; otherwise the relative tolerance."""
    if any(s in key for s in COMPARE_SKIP):
        return None
    for sub, rtol in COMPARE_RTOL:
        if sub in key:
            return rtol
    return COMPARE_RTOL[-1][1]


def _diff_payload(prev, cur, path: str, diffs: list, news: list) -> None:
    """Recursively diff ``cur`` against baseline ``prev``.

    Appends ``(path, baseline, current, note)`` rows: regressions to
    ``diffs`` (fail), additions only present in ``cur`` to ``news``
    (allowed — benchmarks may grow new sections/metrics).
    """
    key = path.rsplit(".", 1)[-1]
    if cur is _MISSING:
        if _leaf_rtol(key) is not None or isinstance(prev, (dict, list)):
            diffs.append((path, prev, "<missing>", "dropped from payload"))
        return
    if prev is _MISSING:
        news.append((path, "<none>", cur, "new in payload"))
        return
    if isinstance(prev, dict) or isinstance(cur, dict):
        if not (isinstance(prev, dict) and isinstance(cur, dict)):
            diffs.append((path, prev, cur, "type changed"))
            return
        for k in sorted(set(prev) | set(cur), key=str):
            _diff_payload(prev.get(k, _MISSING), cur.get(k, _MISSING),
                          f"{path}.{k}", diffs, news)
        return
    if isinstance(prev, list) or isinstance(cur, list):
        if not (isinstance(prev, list) and isinstance(cur, list)):
            diffs.append((path, prev, cur, "type changed"))
            return
        if len(prev) != len(cur):
            diffs.append((path, f"len={len(prev)}", f"len={len(cur)}",
                          "length changed"))
        for i, (p, c) in enumerate(zip(prev, cur)):
            _diff_payload(p, c, f"{path}[{i}]", diffs, news)
        return
    if isinstance(prev, bool) or isinstance(prev, str) or prev is None \
            or isinstance(cur, bool) or isinstance(cur, str) or cur is None:
        if prev != cur:
            diffs.append((path, prev, cur, "value changed"))
        return
    rtol = _leaf_rtol(key)
    if rtol is None:
        return                                   # host-time metric
    a, b = float(prev), float(cur)
    if a != b and abs(a - b) > rtol * max(abs(a), abs(b), 1e-30):
        diffs.append((path, prev, cur, f"rtol={rtol:g}"))


def baseline_device(payload: dict):
    """The device type a record was made on (``device`` as a string or
    as ``{"type": ...}``), or ``None`` when it does not say."""
    dev = payload.get("device")
    if isinstance(dev, dict):
        dev = dev.get("type")
    return dev


def _fresh_run(name: str, scratch: str, device: str) -> tuple:
    """Run benchmark ``name`` in full into ``scratch``; (returncode,
    stderr)."""
    env = {**os.environ, "REPRO_RESULTS_DIR": scratch}
    r = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_run", "--only", name,
         "--device", device],
        env=env, cwd=REPO_ROOT, capture_output=True, text=True)
    return r.returncode, r.stderr


def run_compare(only: str | None, *, baseline_dir: str = REPO_RESULTS,
                device: str | None = None) -> None:
    """Re-run baselined benchmarks into a scratch dir and diff.  Only the
    baselines made on ``device``'s type (default ``cuda``) are run."""
    import torch

    device = device or "cuda"
    dev_type = torch.device(device).type
    baselines, elsewhere = {}, {}
    for p in sorted(glob.glob(os.path.join(baseline_dir,
                                           "BENCH_torch_*.json"))):
        name = os.path.basename(p)[len("BENCH_"):-len(".json")]
        if only is not None and name != only:
            continue
        with open(p) as f:
            made_on = baseline_device(json.load(f))
        if made_on is None or made_on == dev_type:
            baselines[name] = p
        else:
            elsewhere[name] = made_on
    for name, made_on in elsewhere.items():
        print(f"{name}: baseline made on {made_on}; compares only on a "
              f"{made_on} run, not on {dev_type}")
    if not baselines:
        sys.exit(f"--compare: no BENCH_torch_*.json baseline"
                 f"{' for ' + only if only else 's'} made on {dev_type} "
                 f"in {baseline_dir} to diff against")

    scratch = tempfile.mkdtemp(prefix="bench_compare_")
    print(f"compare mode: {len(baselines)} baselined benchmark(s) on "
          f"{device}, fresh results -> {scratch}")
    failed = []
    for name, base_path in baselines.items():
        print(f"\n--- {name}: re-running (full sweep) ---", flush=True)
        rc, stderr = _fresh_run(name, scratch, device)
        fresh_path = os.path.join(scratch, f"BENCH_{name}.json")
        if rc != 0 or not os.path.exists(fresh_path):
            failed.append(name)
            print(f"{name}: benchmark FAILED to produce a fresh payload "
                  f"(rc={rc})")
            sys.stderr.write(stderr[-2000:])
            continue
        with open(base_path) as f:
            prev = json.load(f)
        with open(fresh_path) as f:
            cur = json.load(f)
        diffs, news = [], []
        _diff_payload(prev, cur, name, diffs, news)
        for path, _, cur_v, note in news:
            print(f"  NEW  {path} = {cur_v}  ({note})")
        if diffs:
            failed.append(name)
            print(f"{name}: {len(diffs)} regression(s) vs {base_path}")
            for path, prev_v, cur_v, note in diffs:
                print(f"  DIFF {path}: baseline={prev_v} "
                      f"current={cur_v}  ({note})")
        else:
            print(f"{name}: OK — every gated leaf reproduces the "
                  f"baseline ({len(news)} new metric(s) allowed)")
    print()
    if failed:
        sys.exit(f"--compare: regressions in {failed}")
    print(f"--compare: all {len(baselines)} baselined benchmark(s) "
          "reproduce their persisted payloads")


def _run_inline(name: str, quick: bool, device) -> None:
    import importlib

    mod = importlib.import_module(f"benchmarks.{name}")
    mod.main(quick=quick, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run the port's benchmarks, or diff them against "
                    "their persisted BENCH_torch_*.json baselines.",
        epilog="torch_serving_load persists no record (it stops at the "
               "reference's calibrated gate, benchmarks/serving_load.py:"
               "514), so --compare has no baseline to hold it to.")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweeps for CI-speed runs")
    ap.add_argument("--only", default=None, choices=BENCH_NAMES)
    ap.add_argument("--inline", action="store_true",
                    help="run all benches in this process (debug only)")
    ap.add_argument("--compare", action="store_true",
                    help="re-run baselined benchmarks into a scratch "
                         "results dir and diff every numeric leaf "
                         "against results/BENCH_torch_*.json")
    ap.add_argument("--device", default=None,
                    help="torch device for every benchmark (default: "
                         "cuda)")
    args = ap.parse_args(argv)

    if args.compare:
        run_compare(args.only, device=args.device)
        return

    if args.only:
        print("name,us_per_call,derived")
        _run_inline(args.only, args.quick, args.device)
        return

    print("name,us_per_call,derived", flush=True)
    failures = []
    for name in BENCH_NAMES:
        if args.inline:
            try:
                _run_inline(name, args.quick, args.device)
            except Exception as e:          # noqa: BLE001
                failures.append(name)
                print(f"{name},-1,ERROR:{e!r}", flush=True)
                traceback.print_exc(file=sys.stderr)
            continue
        cmd = [sys.executable, "-m", "benchmarks.torch_run", "--only", name]
        if args.quick:
            cmd.append("--quick")
        if args.device:
            cmd += ["--device", args.device]
        r = subprocess.run(cmd, env={**os.environ}, cwd=REPO_ROOT,
                           capture_output=True, text=True)
        out = [ln for ln in r.stdout.splitlines()
               if ln.startswith(name + ",")]
        if r.returncode != 0 or not out:
            failures.append(name)
            print(f"{name},-1,ERROR(subprocess rc={r.returncode})",
                  flush=True)
            sys.stderr.write(r.stderr[-2000:])
        else:
            print(out[-1], flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
