#!/usr/bin/env python3
"""Peak device memory and host ms a step of ``chip_smoke.py``'s phase 20
world on several checkouts of this repository, one world each.

    python3 tools/fsdp_ab.py ROOT [ROOT ...]
    python3 tools/fsdp_ab.py --cpu ROOT [ROOT ...]   # SMOKE, on the CPU

Each ``ROOT`` is a checkout's root (``git archive <commit> src/repro_torch
| tar -x -C build/<name>``, or ``.`` for this one); they run in the order
given.  For each, 4 processes join one gloo world sharing cuda:0 and
train Gemma-2B at full width and depth (bf16, adafactor, batch 8 x 512,
lr 3e-3, 2 steps: ``chip_smoke.FSDP_TRAIN``) with
``launch.train.train_loop`` over the (2, 2) ('data', 'model') mesh,
importing that checkout's ``repro_torch``; each rank reports its peak
``torch.cuda.max_memory_allocated``, the host ms of each step (ended by
a synchronize), the bytes ``tp.shard_params`` hands the step, the
gradients' bytes at the clip, the bytes it holds between steps and,
where the checkout gathers per layer, its largest gather over the data
axes (``chip_smoke.fsdp_watch``); a rank that raised (say, out of
device memory) reports its error's last line and its peak so far.  A
checkout from before ZeRO-3 (no ``collectives.fsdp_gather``) gathers
its state over the data axes with ``DTensor.redistribute``, whose own
collectives on CUDA tensors over gloo crash the process: its ranks move
those pieces through the host (``stage_dtensor_redistribute``).  No
kernel is built: this path runs on float weights.  Prints one line a rank and one JSON line a checkout, and
writes them all to ``build/fsdp_ab.json``.  Gloo moves every collective
through the host, so the times say nothing of NCCL across cards.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def stage_dtensor_redistribute(mesh) -> None:
    """Make ``DTensor.redistribute`` in this process move a CUDA
    DTensor's pieces through the host, on a "cpu" mesh over the same
    gloo ranks.  Every rank calls it (the "cpu" mesh is made
    collectively)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    host = DeviceMesh("cpu", mesh.mesh.clone(),
                      mesh_dim_names=mesh.mesh_dim_names)
    orig = DTensor.redistribute

    def redistribute(self, device_mesh=None, placements=None, **kw):
        if self.device_mesh is host:
            return orig(self, device_mesh, placements, **kw)
        out = orig(DTensor.from_local(self.to_local().cpu(), host,
                                      self.placements, run_check=False),
                   host, placements, **kw)
        return DTensor.from_local(out.to_local().to(self.device),
                                  self.device_mesh, out.placements,
                                  run_check=False)

    DTensor.redistribute = redistribute


def watch(torch, mesh) -> dict:
    """A rank's record (``chip_smoke.fsdp_watch``); on a checkout from
    before ZeRO-3, ``chip_smoke.watch_step``'s, its redistributes
    staged through the host."""
    import chip_smoke as cs
    from repro_torch.parallel import collectives as C

    if hasattr(C, "fsdp_gather"):
        return cs.fsdp_watch(torch, mesh)
    stage_dtensor_redistribute(mesh)
    return cs.watch_step(torch)


def main(argv) -> int:
    cpu = "--cpu" in argv
    roots = [Path(a).resolve() for a in argv if a != "--cpu"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    # as chip_smoke.main: the allocator's segments, cuBLAS's fixed
    # workspace for training's deterministic kernels (the ranks inherit)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs

    if not cpu and not torch.cuda.is_available():
        print("fsdp_ab: no CUDA device", file=sys.stderr)
        return 1
    cs.DEV = "cpu" if cpu else "cuda"
    out = []
    (ROOT / "build").mkdir(exist_ok=True)
    for root in roots:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ranks = cs.fsdp_world(torch, tmp, str(root / "src"), cs.DEV,
                                  cpu, None, watch)
        rec = dict(root=str(root), device=(
            "cpu" if cpu else torch.cuda.get_device_name(0)),
            nvidia_smi=None if cpu else cs.nvidia_smi(),
            errors=[r["error"].strip().splitlines()[-1] if "error" in r
                    else None for r in ranks],
            losses=ranks[0].get("losses"),
            peak_gb=[r["peak_gb"] for r in ranks],
            step_ms=[r.get("step_ms") for r in ranks],
            median_step_ms=[statistics.median(r["step_ms"][1:] or
                                              r["step_ms"])
                            if r.get("step_ms") else None for r in ranks],
            ranks=ranks)
        for r, res in enumerate(ranks):
            line = (cs.fsdp_rank_line(r, res) if "error" not in res else
                    f"rank {r}: failed, peak {res['peak_gb']:.2f} GB so "
                    f"far: {rec['errors'][r][:300]}")
            print(f"[fsdp_ab] {root.name}: {line}", flush=True)
        print(json.dumps({k: v for k, v in rec.items() if k != "ranks"}),
              flush=True)
        out.append(rec)
    (ROOT / "build" / "fsdp_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
