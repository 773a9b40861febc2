#!/bin/bash
# Trial runs of cells on a GPU: each named cell once per trace mode.
# usage: bash benchmark/tools/trial.sh OUTDIR SECONDS SEED CELL...
out=$1; secs=$2; seed=$3; shift 3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/smi.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for cell in "$@"; do
  for tr in 0 1; do
    seed=$((seed + 1))
    SECONDS=0
    python3 -m benchmark.run --workload "$cell" --seed "$seed" --seconds "$secs" --trace "$tr" \
      > "$out/$cell.$tr.out" 2> "$out/$cell.$tr.err"
    echo "== $cell trace=$tr seed=$seed rc=$? wall=${SECONDS}s"
    grep -v "^ptxas\|^nvcc" "$out/$cell.$tr.err" | tail -n 25
    tail -n 1 "$out/$cell.$tr.out" | cut -c1-1500
  done
done
