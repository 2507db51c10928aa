"""The control of the output check: the reference put in the program's
place and computed in bfloat16, one precision below the float32 that the
configurations state, compared with the float32 reference as the check
compares the program (the reference's own ``compare``).  The check's
limits hold only if this control fails them.

    python3 bench/control.py --workload <name> --seeds 11,12,13 [--calls 3]

Runs on the card at the cell's own size (the benchmark's runs never run
it) and prints one JSON line per seed and call: each number compared
with its limit.
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.harness import check, spec  # noqa: E402

CALL_RANGE = 100  # calls are drawn from the first CALL_RANGE of a run


def control(config: dict, traffic: dict, seed: int, calls: int, device: str):
    """``[(call, numbers)]``: the float32 reference's comparison of the
    bfloat16 reference's outputs, on ``calls`` calls drawn from the seed;
    ``numbers`` maps each name to ``(value, limit)``."""
    exact = spec.reference(config, traffic, seed, device)
    low = spec.reference(config, traffic, seed, device, precision="bfloat16")
    picks = random.Random(seed).sample(range(CALL_RANGE), calls)
    return [(i, exact.compare([(i, low.outputs(i))])[0]) for i in picks]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for i, numbers in control(cell.config, cell.traffic, seed, args.calls, "cuda"):
            compared = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
            print(json.dumps({"workload": args.workload, "seed": seed, "call": i, "compared": compared,
                              "fails": not check.holds(numbers)}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
