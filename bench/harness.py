"""One run of one cell: find its files by name, set up, warm up, measure
the window, check the outputs against the plain reference, print the
result line.

A cell's workload file (``workloads/<cell>.json``) names its
configuration (``configs/<config>.json``) and its driver
(``drivers/<driver>.py``, a ``Driver`` class); ``BENCHMARK.json`` lists
which end-to-end metrics the cell reports and which per-layer metrics
its traced run reads (``metrics/<metric>.py``, a ``read`` function).
Files are looked up in each of ``roots`` in turn, so a new cell,
configuration, driver or metric is a new file."""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from bench.trace import Tracer

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
"""Top-level modules that may not be loaded: the JAX package and JAX."""


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``ok`` when ``value <= limit``
    (a NaN is never ok)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Run:
    """What a driver is given: the seed, the window's seconds, the cell's
    configuration and workload dicts, the device and the tracer (whose
    ``span`` labels a call into the program)."""
    cell: str
    seed: int
    seconds: float
    config: dict
    workload: dict
    device: torch.device
    tracer: Tracer

    def span(self, name: str):
        return self.tracer.span(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def find(kind: str, name: str, suffix: str, roots: Sequence[Path]) -> Path:
    """``<root>/<kind>/<name><suffix>`` in the first root that has it."""
    for root in roots:
        path = Path(root) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind[:-1]} {name!r} under "
                            f"{[str(r) for r in roots]}")


def load_json(kind: str, name: str, roots) -> dict:
    return json.loads(find(kind, name, ".json", roots).read_text())


def load_module(kind: str, name: str, roots):
    path = find(kind, name, ".py", roots)
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(cell: str, roots, smoke: bool = False):
    """(workload, config) dicts of ``cell``; ``smoke`` merges each file's
    ``"smoke"`` entries, its CPU test sizes."""
    workload = load_json("workloads", cell, roots)
    config = load_json("configs", workload["config"], roots)
    if smoke:
        config = {**config, **config.get("smoke", {})}
        workload = {**workload, **workload.get("smoke", {})}
    return workload, config


def cell_metrics(manifest: dict, cell: str):
    """(end-to-end entries, per-layer entries) that ``cell`` reports: an
    entry with ``workloads`` where it lists the cell; a per-layer entry
    without it wherever its ``moves`` metric is reported."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest.get("per_layer", [])
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _finite(x: float) -> float:
    """``x``, or 1e300 for an infinite or undefined reading, which strict
    JSON cannot hold."""
    return x if math.isfinite(x) else 1e300


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             roots: Sequence[Path] = (BENCH,), manifest: Optional[dict] = None,
             device: Optional[str] = None, smoke: bool = False,
             t_start: Optional[float] = None) -> dict:
    """Run ``cell`` once; returns the result dict (its ``checks`` the
    numbers compared, each with its limit).  ``device`` defaults to the
    CUDA device; ``smoke`` runs the configuration at its CPU test sizes
    (``"smoke"`` in its file)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest if manifest is not None else json.loads(
        MANIFEST.read_text())
    workload, config = load_cell(cell, roots, smoke)
    dev = torch.device(device or "cuda")
    run = Run(cell, seed, seconds, config, workload, dev, Tracer(trace))
    driver = load_module("drivers", workload["driver"], roots).Driver(run)
    run.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    with run.tracer.window():
        driver.window()
    run.sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e, layer = cell_metrics(manifest, cell)
    metrics = {}
    if trace:
        view = run.tracer.view(driver.info(), config, workload)
        for m in layer:
            value = load_module("metrics", m["name"], roots).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": _finite(value),
                                      "unit": m["unit"]}
    else:
        values = {**driver.metrics(), "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": _finite(values[m["name"]]),
                                  "unit": m["unit"]}
    attempted, failed = driver.attempted()
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else dev.type,
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev_info["busy_s"] = view.busy_s
        dev_info["window_s"] = view.window_s
        breakdown = run.tracer.breakdown()
    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()
    result = {"correct": all(c.ok for c in checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit}
                        for c in checks}
    bad = loaded_forbidden()
    if bad:
        raise ForbiddenImport(bad)
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the measuring process: "
                         + ", ".join(names))


def main(argv: Optional[Sequence[str]] = None,
         t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads(MANIFEST.read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), manifest=manifest,
                          t_start=t_start)
    except ForbiddenImport as err:
        print(str(err), file=sys.stderr)
        return 3
    if args.trace:
        print(f"[bench] card and power limit: {_power_limit()}; shares are "
              "of the published peaks at 700 W", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
