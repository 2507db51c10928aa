#!/usr/bin/env bash
# Trace dry-run cells in parallel: one process per (arch, mesh), JOBS at a
# time, each with its own fake world (repro_torch.launch.dryrun allows one a
# process).  Writes OUT/<arch>_<mesh>.json and .log, then prints one line a
# cell (peak and collective GB a chip, or the error) and the totals.
#
#   scripts/dryrun_cells.sh OUT [JOBS] [--shape SHAPE] [ARCH ...]
#
# Default: every arch, every shape, both production meshes, 7 jobs.  On an
# 8-core host the whole sweep took ~10 min under torch 2.11 (7 jobs) and
# ~25 min under 2.13 (4 jobs), whose 3-D mesh cells plan slowly.
set -u
out=${1:?usage: dryrun_cells.sh OUT [JOBS] [--shape SHAPE] [ARCH ...]}
shift
jobs=7
if [[ "${1:-}" =~ ^[0-9]+$ ]]; then jobs=$1; shift; fi
shape=""
if [ "${1:-}" = "--shape" ]; then shape="--shape $2"; shift 2; fi
cd "$(dirname "$0")/.." || exit 1
archs=("$@")
if [ ${#archs[@]} -eq 0 ]; then
  read -r -a archs <<< "$(PYTHONPATH=src python -c 'from repro_torch import configs; print(*configs.ARCHS)')"
fi
mkdir -p "$out"
export out shape
for a in "${archs[@]}"; do
  printf '%s 16x16\n%s 2x16x16\n' "$a" "$a"
done | xargs -P "$jobs" -L 1 bash -c '
  flag=""; [ "$1" = 2x16x16 ] && flag=--multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch "$0" $flag $shape \
      --out "$out/$0_$1.json" > "$out/$0_$1.log" 2>&1
  echo "$0 $1 rc=$?"'
PYTHONPATH=src python - "$out" <<'PY'
import glob, json, sys

rows = [r for f in sorted(glob.glob(sys.argv[1] + "/*.json")) for r in json.load(open(f))]
for r in rows:
    if r["status"] == "ok":
        coll = " ".join(f"{k}={v / 1e9:.4f}" for k, v in r["coll_breakdown"].items() if v)
        print(f"{r['arch']} {r['shape']} {r['mesh']} ok peak={r['peak_bytes_per_chip'] / 2**30:.2f}GiB"
              f" coll_GB {coll} trace={r['trace_s']:.1f}s")
    else:
        print(f"{r['arch']} {r['shape']} {r['mesh']} {r['status']}: {r.get('error', r.get('reason'))[:400]}")
n = {s: sum(r["status"] == s for r in rows) for s in ("ok", "skipped", "failed")}
print(f"cells: {n['ok']} ok, {n['skipped']} skipped, {n['failed']} FAILED")
PY
