#!/bin/bash
# Runs of one cell with trace 0, one seed each, back to back in this call:
# the spread that a bound is set from.
# usage: bash benchmark/tools/sets.sh OUTDIR CELL SECONDS FIRST_SEED RUNS [TRACE]
out=$1; cell=$2; secs=$3; seed=$4; runs=$5; tr=${6:-0}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out/smi.txt"
for i in $(seq 1 "$runs"); do
  s=$((seed + i - 1))
  SECONDS=0
  python3 -m benchmark.run --workload "$cell" --seed "$s" --seconds "$secs" --trace "$tr" \
    > "$out/$cell.$s.$tr.out" 2> "$out/$cell.$s.$tr.err"
  rc=$?
  echo "== $cell seed=$s trace=$tr rc=$rc wall=${SECONDS}s"
  tail -n 1 "$out/$cell.$s.$tr.out" >> "$out/lines.jsonl"
  [ $rc -ne 0 ] && tail -n 20 "$out/$cell.$s.$tr.err"
  tail -n 1 "$out/$cell.$s.$tr.out" | cut -c1-400
done
