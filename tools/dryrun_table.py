#!/usr/bin/env python3
"""Dry-run records as one row per (arch, cell), both meshes side by side,
with the memory a device holds as a factor of its arguments' shards.

    python3 tools/dryrun_table.py build/dryrun.json [--before OLD.json]

``python -m repro_torch.launch.dryrun --all --both-meshes --out
build/dryrun.json`` writes the records (``python -m
repro_torch.launch.report`` renders them one row a record).  For each
cell and mesh: the roofline terms compute / memory / collective in ms
(``report``'s format) and the bottleneck; the arguments' GiB a device
holds -- the local shards of the step's inputs under the sharding specs,
which are the reference's ``PartitionSpec``s leaf for leaf
(``tests/test_torch_dryrun.py`` holds them equal) -- and (arguments +
temporaries) / arguments, what a device holds during the step beyond its
shards; ``useful %`` ``report``'s model flops over the chips' device
flops.  ``--before`` names another run's records (an older commit's):
each 16x16 row then also shows its terms, useful % and factor there.
Failed cells are listed with their error.  Reads JSON only.
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


def _useful(r) -> str:
    if r is None or r.get("status") != "ok":
        return "-"
    return f"{100 * r['useful_ratio']:.1f}"


def _mem(r) -> str:
    if r is None or r.get("status") != "ok":
        return "- | -"
    m = r["memory_per_device"]
    args, temp = m["argument_bytes"], m["temp_bytes"]
    return f"{args / 2**30:.3f} | {(args + temp) / args:.0f}"


def rows(records, before=()):
    by, old = {}, {}
    for r in records:
        by.setdefault((r["arch"], r["cell"]), {})[r["mesh"]] = r
    for r in before:
        old[(r["arch"], r["cell"], r["mesh"])] = r
    head = ("| arch | cell | 16x16 ms: compute / memory / collective | bound"
            " | useful % | 2x16x16 ms | bound | useful % | 16x16 args GiB/dev"
            " | x | 2x16x16 args GiB/dev | x |")
    rule = "|---|---|---|---|---:|---|---|---:|---:|---:|---:|---:|"
    if before:
        head += " before: 16x16 ms | bound | useful % | args | x |"
        rule += "---|---|---:|---:|---:|"
    yield head
    yield rule
    for (arch, cell), rs in by.items():
        a, b = (rs.get(m) for m in MESHES)
        line = (f"| {arch} | {cell} | {_terms(a)} | {_useful(a)} | "
                f"{_terms(b)} | {_useful(b)} | {_mem(a)} | {_mem(b)} |")
        if before:
            o = old.get((arch, cell, MESHES[0]))
            line += f" {_terms(o)} | {_useful(o)} | {_mem(o)} |"
        yield line
    for r in records:
        if r.get("status") != "ok":
            yield (f"\nFAIL {r['arch']} {r['cell']} {r['mesh']}: "
                   f"{r.get('error', '?')}")


def _load(path):
    with open(path) as f:
        recs = json.load(f)
    return recs if isinstance(recs, list) else [recs]


def main(argv) -> None:
    before = []
    if "--before" in argv:
        i = argv.index("--before")
        before = _load(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    records = [r for path in argv for r in _load(path)]
    print("\n".join(rows(records, before)))


if __name__ == "__main__":
    main(sys.argv[1:])
