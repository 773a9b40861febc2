#!/bin/bash
# The readings a cell's limits are set from (benchmark/calibrate.py), one
# process per cell: N program seeds from FIRST_SEED, 3 control seeds after.
# usage: bash benchmark/tools/calibrate.sh OUTDIR FIRST_SEED N CELL...
out=$1; seed=$2; n=$3; shift 3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out/smi.txt"
for cell in "$@"; do
  SECONDS=0
  python3 -m benchmark.calibrate --workload "$cell" --out "$out/calibrate.jsonl" \
    --seeds $(seq "$seed" $((seed + n - 1))) \
    --control-seeds $(seq $((seed + n)) $((seed + n + 2))) 2> "$out/$cell.calibrate.err" | cut -c1-600
  echo "== $cell calibrate rc=$? wall=${SECONDS}s"
  tail -n 5 "$out/$cell.calibrate.err"
done
