#!/bin/bash
# Trace the LM dry run's cells, one process a cell and JOBS at a time,
# into DIR, then print the markdown table of tools/dryrun_table.py.
#
#   tools/dryrun_sweep.sh DIR [JOBS] [SHAPE ...]
#
# With no SHAPE every cell of launch.dryrun.cells() runs on both meshes
# (32x8 and 2x32x8); with SHAPEs, only those shapes' cells. Cells already
# in DIR are skipped (--skip-existing). The prefill cells start first:
# they take longest (a MoE prefill of 32 x 32768 tokens, about 15 min on
# one core). Each process runs one intra-op thread. Exits non-zero if a
# cell failed; DIR/log.txt has each cell's summary line or its error.
set -uo pipefail
out=${1:?usage: tools/dryrun_sweep.sh DIR [JOBS] [SHAPE ...]}
jobs=${2:-8}
shift $(( $# >= 2 ? 2 : 1 ))
cd "$(dirname "$0")/.."
mkdir -p "$out"
export PYTHONPATH=src OMP_NUM_THREADS=1
PYTHONPATH=src python3 - "$@" <<'PY' > "$out/cells.txt"
import sys
from repro_torch.launch.dryrun import cells
want = set(sys.argv[1:])
todo = [(a, s) for a, s in cells() if not want or s in want]
todo.sort(key=lambda c: c[1] != "prefill_32k")
for a, s in todo:                   # no trailing blank: xargs -L joins
    print(a, s, "--multi-pod")      # such a line to the next
    print(a, s)
PY
xargs -P "$jobs" -L 1 sh -c 'python3 -m repro_torch.launch.dryrun \
    --arch "$0" --shape "$1" $2 --out "'"$out"'" --skip-existing \
    > /dev/null 2>> "'"$out"'/log.txt" || echo "FAIL $0 $1 $2" >> "'"$out"'/failed.txt"' \
    < "$out/cells.txt"
python3 tools/dryrun_table.py "$out"
test ! -s "$out/failed.txt"
