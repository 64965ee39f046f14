#!/usr/bin/env bash
# The port's paper benchmarks on one card, in one process each:
# Fig. 8, Fig. 9, Fig. 10, Table 1 and the ablations with --quick, and
# the kernel micro-benchmark with and without --quick.
#
#   bash scripts/torch_paper_bench.sh [OUT_DIR]
#
# OUT_DIR (default chiprun_out/paper_bench) receives every CSV
# (bench/torch_*.csv) and BENCH_torch_kernels_micro.json (the full-shape
# run; the --quick run's record is kept beside it as
# BENCH_torch_kernels_micro_quick.json).  The models come from
# benchmarks/torch_common.train_or_load (trained on the card when
# results/trained_torch/ holds none).  Prints the card's name and power
# limit first and every CSV last.
set -euo pipefail
cd "$(dirname "$0")/.."
out=${1:-chiprun_out/paper_bench}
mkdir -p "$out"
export REPRO_RESULTS_DIR=$out PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for b in fig8_accuracy fig9_energy fig10_warmup table1_amat ablations \
         kernels_micro; do
    t0=$(date +%s%N)
    python3 "benchmarks/torch_$b.py" --quick --device cuda
    echo "[bench] torch_$b --quick: $(( ($(date +%s%N) - t0) / 1000000 )) ms"
done
mv "$out/BENCH_torch_kernels_micro.json" \
    "$out/BENCH_torch_kernels_micro_quick.json"
cp "$out/bench/torch_kernels_micro.csv" "$out/bench/torch_kernels_micro_quick.csv"
python3 benchmarks/torch_kernels_micro.py --device cuda
for f in "$out"/bench/*.csv; do
    echo "== $f"
    cat "$f"
done
