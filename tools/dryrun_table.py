#!/usr/bin/env python3
"""Dry-run records as one row per (arch, cell), both meshes side by side,
with the memory a device holds as a factor of its arguments' shards.

    python3 tools/dryrun_table.py build/dryrun.json

``python -m repro_torch.launch.dryrun --all --both-meshes --out
build/dryrun.json`` writes the records (``python -m
repro_torch.launch.report`` renders them one row a record).  For each
cell and mesh: the roofline terms compute / memory / collective in ms
(``report``'s format) and the bottleneck; the arguments' GiB a device
holds -- the local shards of the step's inputs under the sharding specs,
which are the reference's ``PartitionSpec``s leaf for leaf
(``tests/test_torch_dryrun.py`` holds them equal) -- and (arguments +
temporaries) / arguments, what a device holds during the step beyond its
shards.  Failed cells are listed with their error.  Reads JSON only.
"""

import json
import sys

MESHES = ("16x16", "2x16x16")


def _ms(x) -> str:
    return f"{x * 1e3:.1f}" if x < 10 else f"{x * 1e3:.0f}"


def _terms(r) -> str:
    if r is None or r.get("status") != "ok":
        return "- | -"
    return (f"{_ms(r['t_compute'])} / {_ms(r['t_memory'])} / "
            f"{_ms(r['t_collective'])} | {r['bottleneck']}")


def _mem(r) -> str:
    if r is None or r.get("status") != "ok":
        return "- | -"
    m = r["memory_per_device"]
    args, temp = m["argument_bytes"], m["temp_bytes"]
    return f"{args / 2**30:.3f} | {(args + temp) / args:.0f}"


def rows(records):
    by = {}
    for r in records:
        by.setdefault((r["arch"], r["cell"]), {})[r["mesh"]] = r
    yield ("| arch | cell | 16x16 ms: compute / memory / collective | bound"
           " | 2x16x16 ms | bound | 16x16 args GiB/dev | x | 2x16x16 args"
           " GiB/dev | x |")
    yield "|---|---|---|---|---|---|---:|---:|---:|---:|"
    for (arch, cell), rs in by.items():
        a, b = (rs.get(m) for m in MESHES)
        yield (f"| {arch} | {cell} | {_terms(a)} | {_terms(b)} | "
               f"{_mem(a)} | {_mem(b)} |")
    for r in records:
        if r.get("status") != "ok":
            yield (f"\nFAIL {r['arch']} {r['cell']} {r['mesh']}: "
                   f"{r.get('error', '?')}")


def main(paths) -> None:
    records = []
    for path in paths:
        with open(path) as f:
            recs = json.load(f)
        records.extend(recs if isinstance(recs, list) else [recs])
    print("\n".join(rows(records)))


if __name__ == "__main__":
    main(sys.argv[1:])
