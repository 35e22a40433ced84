"""Render dry-run JSON reports into markdown tables (port of
``repro/launch/report.py``; either package's records render alike).

  python -m repro_torch.launch.report build/dryrun.json [more.json ...]
"""

from __future__ import annotations

import json
import sys
from typing import List


def _fmt_ms(x) -> str:
    if x is None:
        return "-"
    return f"{x * 1e3:.1f}" if x < 10 else f"{x * 1e3:.0f}"


def render(records: List[dict]) -> str:
    out = []
    out.append("| arch | cell | mesh | compute ms | memory ms | collective ms"
               " | bottleneck | useful % | roofline frac % | HBM GiB/dev"
               " (args+temp) | status |")
    out.append("|---|---|---|---:|---:|---:|---|---:|---:|---:|---|")
    for r in records:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['cell']} | {r['mesh']} |"
                       " - | - | - | - | - | - | - |"
                       f" FAIL: {r.get('error', '?')[:60]} |")
            continue
        mem = r.get("memory_per_device") or {}
        hbm = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)) / 2**30
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} |"
            f" {_fmt_ms(r['t_compute'])} | {_fmt_ms(r['t_memory'])} |"
            f" {_fmt_ms(r['t_collective'])} | {r['bottleneck']} |"
            f" {r['useful_ratio'] * 100:.1f} |"
            f" {r['roofline_fraction'] * 100:.1f} | {hbm:.1f} | ok |")
    return "\n".join(out)


def main() -> None:
    records = []
    for path in sys.argv[1:]:
        with open(path) as f:
            recs = json.load(f)
            records.extend(recs if isinstance(recs, list) else [recs])
    print(render(records))


if __name__ == "__main__":
    main()
