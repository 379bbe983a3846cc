#!/bin/bash
# The dry run over every (architecture x shape) cell on both production
# meshes, one process per mesh, both started together, each timed;
# results and logs go to the directory given (default build/dryrun,
# git-ignored). Run from the repository's root:
#   bash scripts/dryrun_all.sh [out_dir]
set -o pipefail
out=${1:-build/dryrun}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
declare -A pids
for mp in "" "--multi-pod"; do
  tag=${mp:+2x16x16}; tag=${tag:-16x16}
  PYTHONPATH=src python3 -m repro_torch.launch.dryrun --all $mp \
    --out "$out/dryrun_$tag.json" > "$out/dryrun_$tag.log" 2>&1 &
  pids[$tag]=$!
done
status=0
for tag in 16x16 2x16x16; do
  wait "${pids[$tag]}"
  rc=$?
  echo "$tag rc=$rc"
  grep -E "^wall|DRY-RUN" "$out/dryrun_$tag.log"
  [ $rc -eq 0 ] || status=$rc
done
exit $status
