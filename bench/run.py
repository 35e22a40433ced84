"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA device.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which the last lines of
standard error repeat).  Without a CUDA device, or without the program
under ``src/``, it exits non-zero and prints no result."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own directory would shadow modules (``trace``) by
# ``bench``'s file names; the package is imported from the root instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve()
               != Path(__file__).resolve().parent]
# caches of the program's toolchains at fixed paths inside the checkout
# (the port's own CUDA build goes to build/repro_torch)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "bench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "build" / "bench" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
