#!/usr/bin/env bash
# Run chip_smoke.py from two unpacked trees in turns (A, B, B, A), each from
# its own root, so that a change and its parent are timed in one session on
# one card.  Each run's output goes to LOG_DIR/<label>.log; the script
# prints the card's name and power limit, each run's exit code and the
# tail of its output, and exits 1 when any run failed.
#
#   git archive <parent> | tar -x -C build/parent
#   git archive $(git write-tree) | tar -x -C build/change
#   bash tools/chip_ab.sh build/parent build/change build/ab
set -u
if [ $# -ne 3 ]; then
    echo "usage: $0 PARENT_DIR CHANGE_DIR LOG_DIR" >&2
    exit 2
fi
mkdir -p "$3"
out="$(cd "$3" && pwd)"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for run in "parent1:$1" "change1:$2" "change2:$2" "parent2:$1"; do
    label=${run%%:*}
    dir=${run#*:}
    start=$(date +%s)
    (cd "$dir" && python3 chip_smoke.py) > "$out/$label.log" 2>&1
    r=$?
    echo "== $label ($dir): exit $r, $(( $(date +%s) - start )) s"
    tail -n 2 "$out/$label.log"
    [ "$r" -eq 0 ] || rc=1
done
exit $rc
