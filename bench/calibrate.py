"""The readings a cell's limits are set from, in one process: the
program's checks on many seeds (each a whole run of the cell, its window
``--seconds`` long) and the control's on a few (the reference one
precision step below the configuration's, in the program's place, at the
cell's own size).  Benchmark runs never run it.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 \\
        --controls 3 [--device cpu --smoke]

Prints one JSON line per reading: ``{"seed", "side": "program" |
"control", "checks"}``."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the script's own directory would shadow modules (``trace``) by
# ``bench``'s file names; the package is imported from the root instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve()
               != Path(__file__).resolve().parent]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.trace import Tracer  # noqa: E402


def control(cell: str, seed: int, *, device: str = "cuda",
            smoke: bool = False, roots=(harness.BENCH,)) -> dict:
    """The control's checks of ``cell`` on ``seed``: ``{name: (value,
    limit)}``."""
    workload, config = harness.load_cell(cell, roots, smoke)
    run = harness.Run(cell, seed, 0.0, config, workload, torch.device(device),
                      Tracer(False))
    driver = harness.load_module("drivers", workload["driver"], roots)
    return {c.name: (c.value, c.limit) for c in driver.control(run)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             device=args.device, smoke=args.smoke)
        print(json.dumps({"seed": seed, "side": "program",
                          "checks": r["checks"], "metrics": r["metrics"],
                          "s": time.perf_counter() - t0}), flush=True)
    for seed in seeds[:args.controls]:
        t0 = time.perf_counter()
        checks = control(args.workload, seed, device=args.device,
                         smoke=args.smoke)
        print(json.dumps({"seed": seed, "side": "control", "checks": checks,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
