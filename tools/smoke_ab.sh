#!/usr/bin/env bash
# Compare two trees of this repository on one card with chip_smoke.py, in
# the order parent, change, change, parent: the parent with --profile, the
# change plain, the change with --profile, the parent plain.
#
#   tools/smoke_ab.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Each tree is a full checkout (for example `git archive` unpacked into a
# directory that .gitignore lists); each builds its own kernels under its
# own build/.  Every run's output goes to OUT_DIR/{parent,change}_
# {plain,profile}.txt; the script prints each run's exit code and its last
# line, and exits 1 if any run failed.
set -u
if [ $# -ne 3 ]; then
  echo "usage: $0 PARENT_DIR CHANGE_DIR OUT_DIR" >&2
  exit 2
fi
parent=$(cd "$1" && pwd) change=$(cd "$2" && pwd)
mkdir -p "$3" && out=$(cd "$3" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for run in parent:profile change:plain change:profile parent:plain; do
  tree=${run%%:*} mode=${run##*:}
  dir=$parent
  [ "$tree" = change ] && dir=$change
  flag=
  [ "$mode" = profile ] && flag=--profile
  log=$out/${tree}_${mode}.txt
  (cd "$dir" && python3 chip_smoke.py $flag) > "$log" 2>&1
  rc=$?
  echo "${tree}_${mode} rc=$rc: $(tail -n 1 "$log" | cut -c1-200)"
  [ $rc -eq 0 ] || status=1
done
exit $status
