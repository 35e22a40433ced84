#!/usr/bin/env python3
"""How far RecurrentGemma-2B split over 'model' lands from one device,
beside how far one device lands from itself in another float order.

    PYTHONPATH=src python3 tools/tp_float_order.py [--layers 3] \
        [--prompt 200] [--batch 2]

On the CPU, at full width, the first ``--layers`` layers, radix T = 4
with ``radix_attn`` as phase 19 of ``chip_smoke.py`` runs it, seeded
weights and prompt; the prefill's last-token logits

1. on one device;
2. on one device with every bf16 ``@`` product (RG-LRU's three) summed
   in float32 and rounded once: another float order of the same
   function;
3. over the (1, 4) ('data', 'model') mesh on 4 gloo ranks (each rank
   attending for its own query rows where the heads split head_dim);
4. the same with every rank attending for every row.

Prints the relative L2 of 2-4 from 1, and of 3 from 4.  The ranks are
spawned processes joined through a file store in a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

RANKS = 4
RADIX = dict(quant="radix", radix_steps=4, radix_kv_pack=True,
             packed_attn=True, radix_attn=True, use_kernel=True,
             kernel_dataflow="fused")


def _cfg(layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("recurrentgemma_2b"),
                               n_layers=layers, **RADIX)


def _params(cfg):
    from repro_torch.lm import model

    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    return model.kmajor_params(model.radixify_params(params, cfg))


def _logits(params, cfg, tokens, mesh=None) -> np.ndarray:
    from repro_torch.lm import model

    s0 = tokens.shape[1] - 1
    with torch.inference_mode():
        last, _ = model.prefill(params, {"tokens": tokens}, cfg, mesh,
                                max_len=s0)
    return last.float().numpy()


@contextlib.contextmanager
def float32_matmul():
    """Every bf16 ``@`` summed in float32 and rounded once."""
    mm = torch.Tensor.__matmul__

    def f32(a, b):
        if a.dtype == b.dtype == torch.bfloat16:
            return mm(a.float(), b.float()).to(torch.bfloat16)
        return mm(a, b)

    torch.Tensor.__matmul__ = f32
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = mm


@contextlib.contextmanager
def whole_attention():
    """Every rank attending for every query row."""
    from repro_torch.lm import blocks

    rows_path = blocks._rows_path
    blocks._rows_path = lambda *a: False
    try:
        yield
    finally:
        blocks._rows_path = rows_path


def _rank(rank: int, store: str, out: str, layers: int, tokens) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lm import model

    torch.set_num_threads(max(1, (os.cpu_count() or RANKS) // RANKS))
    dist.init_process_group("gloo", store=dist.FileStore(store, RANKS),
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=1800))
    try:
        cfg = _cfg(layers)
        mesh = make_mesh((1, RANKS), ("data", "model"))
        sharded = model.shard(_params(cfg), cfg, mesh)
        rows = _logits(sharded, cfg, tokens, mesh)
        with whole_attention():
            whole = _logits(sharded, cfg, tokens, mesh)
        if rank == 0:
            np.savez(out, rows=rows, whole=whole)
    finally:
        dist.destroy_process_group()


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--prompt", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    if args.prompt % RANKS:
        sys.exit(f"--prompt must divide {RANKS}: the sequence split")

    cfg = _cfg(args.layers)
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (args.batch, args.prompt + 1)))
    params = _params(cfg)
    one = _logits(params, cfg, tokens)
    with float32_matmul():
        f32 = _logits(params, cfg, tokens)
    del params
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.npz")
        mp.start_processes(_rank, args=(os.path.join(tmp, "store"), out,
                                        args.layers, tokens),
                           nprocs=RANKS, start_method="spawn")
        ranks = np.load(out)
        rows, whole = ranks["rows"], ranks["whole"]
    print(f"RecurrentGemma-2B, {args.layers} layers at full width, radix "
          f"T = 4, {args.batch} x {args.prompt} prompt tokens; last-token "
          "logits, relative L2:")
    print(f"  one device, bf16 @ summed in float32, from one device: "
          f"{_rel(f32, one):.3g}")
    print(f"  (1, 4), each rank its rows, from one device: "
          f"{_rel(rows, one):.3g}")
    print(f"  (1, 4), every rank every row, from one device: "
          f"{_rel(whole, one):.3g}")
    print(f"  (1, 4): its rows against every row: {_rel(rows, whole):.3g}")


if __name__ == "__main__":
    main()
