#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s host time goes: the script run under a
wall-clock stack sampler of its main thread.

    python3 tools/host_profile.py [OUT_DIR]

Runs ``chip_smoke.main()`` from the checkout this file sits in while a
thread reads the main thread's stack every 10 ms (``sys._current_frames``)
and weights each sample by the time since the last, so a call that holds
the interpreter lock still gets its time.  Writes to OUT_DIR (default
``build/``): ``prof_summary.txt`` (inclusive seconds by function,
``chip_smoke`` functions first, then the top frames by line) and
``prof_stacks.txt.gz`` (collapsed stacks, ms).  The spawned ranks of
phases 19 and 20 and the script's CPU subprocesses are not sampled.
Exits with the script's code.
"""

import collections
import gzip
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INTERVAL_S = 0.01
DEPTH = 80


def _summary(stacks, total: float) -> str:
    by_fn, by_line = collections.Counter(), collections.Counter()
    for st, w in stacks.items():
        for frame in set(st):
            by_line[frame] += w
        for fn in {f.rsplit(":", 1)[0] for f in st}:
            by_fn[fn] += w
    lines = [f"total {total:.1f} s, sampled {sum(stacks.values()):.1f} s",
             "== chip_smoke functions (inclusive s)"]
    lines += [f"{w:9.2f} {fn}" for fn, w in by_fn.most_common()
              if fn.startswith("chip_smoke.py:")]
    lines.append("== top functions (inclusive s)")
    lines += [f"{w:9.2f} {fn}" for fn, w in by_fn.most_common(400)]
    lines.append("== top frames by line (inclusive s)")
    lines += [f"{w:9.2f} {fr}" for fr, w in by_line.most_common(600)]
    return "\n".join(lines) + "\n"


def main() -> int:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build"
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    main_id = threading.main_thread().ident
    stacks = collections.Counter()
    stop = threading.Event()

    def sample():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(INTERVAL_S)
            now = time.perf_counter()
            frame, key = sys._current_frames().get(main_id), []
            while frame is not None and len(key) < DEPTH:
                code = frame.f_code
                key.append(f"{os.path.basename(code.co_filename)}:"
                           f"{code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
            stacks[tuple(reversed(key))] += now - last
            last = now

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        return chip_smoke.run()
    finally:
        stop.set()
        sampler.join()
        (out / "prof_summary.txt").write_text(
            _summary(stacks, time.perf_counter() - t0))
        with gzip.open(out / "prof_stacks.txt.gz", "wt") as fh:
            for st, w in stacks.most_common():
                fh.write(";".join(st) + f" {w * 1e3:.0f}\n")


if __name__ == "__main__":
    sys.exit(main())
