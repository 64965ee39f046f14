#!/usr/bin/env bash
# The port's three serving benchmarks on one card, in one process each,
# with --quick: the SLO-controller soak, the sim fidelity gate and the
# serving-load sweep (the counterpart of scripts/bench_serving.sh).  Each
# asserts its claims and exits non-zero on a failed one; every benchmark
# runs, and the script exits with the first failure's code.
#
#   bash scripts/torch_bench_serving.sh [OUT_DIR]
#
# OUT_DIR (default build/serving_bench) receives the CSVs
# (bench/torch_serving_load.csv) and the sim fidelity trace files.
# Prints the card's name and power limit first.
set -uo pipefail
cd "$(dirname "$0")/.."
out=${1:-build/serving_bench}
mkdir -p "$out"
export REPRO_RESULTS_DIR=$out PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for b in controller_soak sim_fidelity serving_load; do
    t0=$(date +%s%N)
    python3 "benchmarks/torch_$b.py" --quick --device cuda
    status=$?
    echo "[bench] torch_$b --quick: exit $status," \
         "$(( ($(date +%s%N) - t0) / 1000000 )) ms"
    if [ "$rc" -eq 0 ]; then rc=$status; fi
done
exit "$rc"
