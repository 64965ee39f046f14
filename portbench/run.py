"""Run one cell of the port's benchmark once, on the machine it is started
on, and print one JSON result line as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiled segment of ``trace_steps`` scheduler steps
follows the window).  Both decide ``correct`` the same way: once the
window has closed, a sample of the requests it finished is run through
the plain reference (the configuration's model module under
``portbench/models/``, over the shared layers of
``portbench/lib/reference.py``) and each served token's logit must lie
within the cell's limit of the reference's best.
The numbers compared are printed, each beside its limit, as the last
lines of standard error and under ``checks`` in the result.

The run exits non-zero, printing no result, without a CUDA device (or
with fewer than the cell asks for), and when a module of JAX or of the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# Host work runs on few threads, so that runs do not contend for cores.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import bench

    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              "none is available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    banned = result.pop("banned_modules")
    if banned:
        print("loaded modules of JAX or of the JAX package: "
              + ", ".join(banned), file=sys.stderr)
        return 3
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
