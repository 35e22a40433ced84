"""(architecture x input-shape) cell definitions and their fake steps
(port of ``repro/launch/cells.py``).

A *cell* is one entry of the assignment matrix: an ArchConfig plus a
ShapeCell (train_4k / prefill_32k / decode_32k / long_500k).  This
module builds a cell's inputs as fake tensors (``FakeTensorMode``: the
shapes and dtypes, no memory), places them on a mesh by the port's
sharding rules (``parallel/sharding.py``, whose specs equal the
reference's ``PartitionSpec``s leaf for leaf), and returns the step that
runs on them: the port's ``make_train_step``, ``prefill`` or
``decode_step`` over the mesh, as each rank of a deployment runs it.

``long_500k`` is defined only for the sub-quadratic archs (rwkv6-3b,
recurrentgemma-2b); pure full-attention archs skip it.  Encoder-decoder
whisper runs decode against its decoder self-cache + fixed cross-cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.lm import model as M
from repro_torch.lm.config import ArchConfig, SHAPE_CELLS, ShapeCell
from repro_torch.lm.radix import torch_dtype
from repro_torch.parallel import sharding as SH
from repro_torch.train import optim as optim_lib
from repro_torch.train.tree import tree_map

__all__ = ["defined_cells", "cell_matrix", "make_batch_abstract",
           "lower_cell", "model_flops"]


def defined_cells(cfg: ArchConfig) -> Tuple[str, ...]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic or (cfg.window and "attn" not in cfg.layer_types):
        cells.append("long_500k")
    return tuple(cells)


def cell_matrix() -> Tuple[Tuple[str, str], ...]:
    """All defined (arch, cell) pairs of the assignment."""
    out = []
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        out.extend((arch, c) for c in defined_cells(cfg))
    return tuple(out)


def make_batch_abstract(cfg: ArchConfig, cell: ShapeCell) -> Dict:
    """Meta-tensor stand-ins for every model input of the cell."""
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "train" or cell.kind == "prefill":
        if cfg.embedding_inputs:
            batch = {"embeds": meta((B, S, cfg.d_model), dt),
                     "labels": meta((B, S), i32)}
        else:
            batch = {"tokens": meta((B, S + 1), i32)}
        if cfg.encoder_layers:
            batch["enc_embeds"] = meta((B, cfg.encoder_ctx, cfg.d_model), dt)
        return batch
    # decode: one new token against a cache of length S
    if cfg.embedding_inputs:
        return {"tokens": meta((B, 1, cfg.d_model), dt)}
    return {"tokens": meta((B, 1), i32)}


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6 * N_active * D (tokens processed)."""
    n = cfg.params_active()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch        # decode: one token per seq


def _fake(meta_tree, mode):
    """Fake (zero-valued) tensors of ``mode`` shaped as ``meta_tree``."""
    with mode:
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                        meta_tree)


def lower_cell(arch: str, cell_name: str, mesh, *, quant: str = "none",
               moe_impl: str = "auto", seq_shard: bool = True,
               remat: bool = True, extra_cfg: Optional[dict] = None,
               mode=None):
    """Build one (arch x cell) on a mesh.  Returns (run, meta): ``run()``
    runs the cell's step once on its placed fake inputs (``run.args``),
    and ``meta`` is ``{cfg, cell, model_flops}``.

    ``mode`` is the ``FakeTensorMode`` the inputs belong to; the caller
    runs ``run()`` inside it (``launch/dryrun.py``, under an analysis),
    kept separate so failures of the step attribute cleanly.
    """
    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    over = dict(quant=quant, seq_shard=seq_shard, remat=remat)
    if extra_cfg:
        over.update(extra_cfg)
    if moe_impl != "auto" and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    cfg = dataclasses.replace(cfg, **over)

    batch = _fake(make_batch_abstract(cfg, cell), mode)
    params = M.abstract_params(cfg, mode)
    pspecs = SH.param_specs(params, cfg, mesh)
    meta = dict(cfg=cfg, cell=cell, model_flops=model_flops(cfg, cell))
    with mode:
        if cell.kind == "decode":
            dp = SH.dp_axes(mesh)
            dp = dp if len(dp) > 1 else (dp[0] if dp else None)
            spec = (dp, None, None) if cfg.embedding_inputs else (dp, None)
            tokens = SH.place(batch["tokens"],
                              SH.sanitize(spec, batch["tokens"].shape, mesh),
                              mesh)
        else:
            batch = SH.place(batch, SH.batch_specs(batch, cfg, mesh,
                                                   seq_shard=seq_shard), mesh)

        if cell.kind == "train":
            opt = optim_lib.adafactor(1e-3)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            sspecs = {"params": pspecs,
                      "opt": SH.opt_state_specs(pspecs, state["opt"], mesh),
                      "step": ()}
            step = M.make_train_step(cfg, opt, mesh=mesh)
            return (functools.partial(step, SH.place(state, sspecs, mesh),
                                      batch), meta)

        placed = SH.place(params, pspecs, mesh)
        if cell.kind == "prefill":
            return (functools.partial(M.prefill, placed, batch, cfg, mesh,
                                      max_len=cell.seq_len), meta)

        # decode: one token at the cache's last position
        caches = M.abstract_cache(cfg, cell.global_batch, cell.seq_len, mode)
        caches = SH.place(caches, SH.cache_specs(caches, cfg, mesh), mesh)
        return (functools.partial(M.decode_step, placed, caches, tokens,
                                  cell.seq_len - 1, cfg, mesh), meta)
