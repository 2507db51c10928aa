"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run builds the program's kernels into
``build/`` of the checkout (only the first run there compiles), sets up
the cell's engine and warms its shapes up, offers the cell's load by its
loop for ``--seconds``, checks a sample of the window's calls against the
plain reference, and prints the result as the last line of standard
output: the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics (from a ``torch.profiler`` trace of the window) with ``--trace 1``.
``bench/README.md`` says which file holds each part of a cell.
The numbers compared with the reference, each beside its limit, are the
last lines of standard error.  Exits non-zero, printing no result, without
the card(s) the cell asks for, or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "repro_torch")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import measure, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    line = measure.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = measure.loaded_forbidden()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures repro_torch alone", file=sys.stderr)
        return 3
    print(f"{args.workload}: {line['attempted']} calls in the window; seed {args.seed}")
    print(json.dumps(line), flush=True)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct {str(line['correct']).lower()}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
