"""The control of a cell's check, on the chip at the cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault NAME ...] [--out FILE]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, the window, the sample of finished requests), then the plain
reference over the sample twice: in float32, which judges the program's
served tokens (the lower readings), and with every matrix product's
operands in float8 e4m3, whose own first choices are judged the same way
(the control, the upper readings).  One JSON line per seed.

With ``--fault``, each seed is run instead once for each fault named,
with the program's decode step broken underneath
(``portbench.lib.faults``) and the check at the cell's own limits; its
line says whether the run came out correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import bench

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from portbench.lib.faults import plant

    cell = bench.load_cell(args.workload)
    t0 = T_START
    runs = [(seed, fault) for seed in args.seeds
            for fault in ([None] if not args.fault else args.fault)]
    for seed, fault in runs:
        mend = plant(fault) if fault else None
        try:
            res = bench.run_cell(cell, seed, args.seconds, False,
                                 torch.device("cuda", 0), t0,
                                 control=fault is None, detail=True)
        finally:
            if mend:
                mend()
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": fault, "correct": res["correct"],
                           "attempted": res["attempted"],
                           "failed": res["failed"],
                           "metrics": res["metrics"],
                           "checks": res["checks"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
