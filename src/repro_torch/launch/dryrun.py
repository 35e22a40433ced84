"""Multi-pod dry run: every (architecture x shape) cell's step, run once
as rank 0 of a placeholder world (port of ``repro/launch/dryrun.py``).

For each cell on the 16x16 single-pod mesh (and the 2x16x16 multi-pod
mesh with --multi-pod), this driver:

  1. joins a placeholder world of 256 (512) ranks: the ``fake`` process
     group, whose collectives move nothing, and the production mesh
     over it (``launch/mesh.py``);
  2. builds the cell's inputs as fake tensors (``FakeTensorMode``: shapes
     and dtypes, no memory) placed by the port's sharding rules, and its
     step (``launch/cells.py``) -- timed as ``lower_s``;
  3. runs the step once under ``launch/op_analysis.analyze`` -- timed as
     ``compile_s``: the ops, shapes and collectives rank 0 of a real
     deployment would run, so a placement or shape fault fails here;
  4. records the per-device costs, the H100 roofline terms
     (``launch/roofline.py``) and the memory per device to a JSON report
     whose records the reference's ``report`` renders too
     (``launch/report.py`` renders either package's).

Memory per device (rank 0): ``argument_bytes`` the local bytes of the
step's inputs, ``output_bytes`` those of its outputs, ``temp_bytes`` the
peak bytes of tensors the step made and held at once, ``alias_bytes`` 0.

The numbers are the port's as it is (ROADMAP queue 1): dense layers split
over 'model', and the train step keeps its state split over the data
axes, gathering one layer at a time (ZeRO-3).

Usage (CPU only; no GPU is touched):
  python -m repro_torch.launch.dryrun --arch gemma_2b --cell train_4k
  python -m repro_torch.launch.dryrun --arch gemma_2b --cell train_4k \
      --cell decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--quant radix]
  python -m repro_torch.launch.dryrun --all --out build/dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch import cells as cells_lib
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.tree import leaves


@contextlib.contextmanager
def placeholder_world(size: int):
    """This process as rank 0 of a ``fake`` process group of ``size``
    ranks, destroyed on exit.  Raises if a process group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own placeholder world; a "
                           "process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``'s tensors (a DTensor's local
    piece), each storage once."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += t.numel() * t.element_size()
    return total


def run_cell(arch: str, cell: str, multi_pod: bool, quant: str = "none",
             moe_impl: str = "auto", seq_shard: bool = True,
             remat: bool = True, verbose: bool = True) -> dict:
    """One cell on the production mesh of the current placeholder world."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    mode = FakeTensorMode()
    t0 = time.time()
    run, meta = cells_lib.lower_cell(
        arch, cell, mesh, quant=quant, moe_impl=moe_impl,
        seq_shard=seq_shard, remat=remat, mode=mode)
    t_lower = time.time() - t0
    t0 = time.time()
    with mode:
        out, cost = op_analysis.analyze(run)
    t_compile = time.time() - t0

    mem = dict(argument_bytes=local_bytes(run.args),
               output_bytes=local_bytes(out),
               temp_bytes=int(cost.peak_bytes), alias_bytes=0)
    rep = roof_lib.roofline(arch, cell, mesh_name, chips, cost,
                            meta["model_flops"], memory_per_device=mem)
    rec = rep.to_dict()
    rec.update(quant=quant, moe_impl=moe_impl, seq_shard=seq_shard,
               remat=remat, lower_s=round(t_lower, 1),
               compile_s=round(t_compile, 1), status="ok")
    if verbose:
        print(f"[dryrun] {roof_lib.format_row(rep)}  "
              f"(lower {t_lower:.0f}s compile {t_compile:.0f}s)")
        gb = {k: v / 2**30 for k, v in mem.items()}
        print("         memory/device GiB: " +
              " ".join(f"{k}={v:.2f}" for k, v in gb.items()))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", action="append", default=None,
                    help="a cell of --arch (repeat for several)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default="none", choices=["none", "radix"])
    ap.add_argument("--moe-impl", default="auto")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        matrix = cells_lib.cell_matrix()
    else:
        if not (args.arch and args.cell):
            ap.error("--arch and --cell (or --all)")
        matrix = tuple((args.arch, c) for c in args.cell)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results, failures = [], []
    for multi_pod in meshes:
        with placeholder_world(512 if multi_pod else 256):
            for arch, cell in matrix:
                try:
                    results.append(run_cell(
                        arch, cell, multi_pod, quant=args.quant,
                        moe_impl=args.moe_impl,
                        seq_shard=not args.no_seq_shard))
                except Exception as e:  # a failure here is a fault to fix
                    traceback.print_exc()
                    rec = {"arch": arch, "cell": cell,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                    results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"[dryrun] wrote {len(results)} cells to {args.out}")
    print(f"[dryrun] {len(results) - len(failures)}/{len(results)} cells OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
