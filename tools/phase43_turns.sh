#!/bin/bash
# Phase 43 (the mesh) alone on two checkouts in turns: before, after,
# after, before; each turn's output goes to OUT_DIR/<side>_<n>.log and its
# step times (2x1, then 1x2) are printed.  Run on the card from the repo
# root, with each checkout unpacked by `git archive` under a directory
# .gitignore lists:
#   tools/phase43_turns.sh [BEFORE_DIR] [AFTER_DIR] [OUT_DIR]
#   (defaults build/ab/before, build/ab/after, build/ab/logs)
before=$(realpath "${1:-build/ab/before}")
after=$(realpath "${2:-build/ab/after}")
mkdir -p "${3:-build/ab/logs}"
out=$(realpath "${3:-build/ab/logs}")
for side in before after after before; do
  dir=$before
  [ "$side" = after ] && dir=$after
  n=$(ls "$out" | grep -c "^$side")
  (cd "$dir" && python3 chip_smoke.py --only 43) > "$out/${side}_$n.log" 2>&1
  echo "$side rc=$? $(grep -o '"ms_per_step": \[[^]]*\]' "$out/${side}_$n.log" | tr '\n' ' ')"
done
