"""Elastic re-scaling: restore a checkpoint onto another topology (port of
``repro/runtime/elastic.py``).

Checkpoints store global arrays (``train/checkpoint.py``), so moving a
run from N to M ranks is a pure re-sharding problem: rebuild the
abstract state, derive the new mesh's specs and placements, and let each
rank read its piece.  The same machinery serves failure recovery (a
shrunken mesh) and scale-up.  Only the tree structure of the checkpoint
must match, not the mesh it was written from.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.parallel import sharding as SH
from repro_torch.train import checkpoint as ckpt_lib

__all__ = ["abstract_train_state", "train_state_shardings",
           "reshard_checkpoint"]


def abstract_train_state(cfg, opt) -> dict:
    """The train state ``{"params", "opt", "step"}`` of ``cfg`` as meta
    tensors (shapes and dtypes, no storage)."""
    from repro_torch.lm import model as M

    params = M.radixify_params(
        M.init_params(torch.Generator(), cfg, device="meta"), cfg)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def train_state_shardings(cfg, opt, mesh) -> Tuple[dict, dict]:
    """(abstract state, its placements on ``mesh``) by the sharding
    rules."""
    state_abs = abstract_train_state(cfg, opt)
    pspecs = SH.param_specs(state_abs["params"], cfg, mesh)
    specs = {"params": pspecs,
             "opt": SH.opt_state_specs(pspecs, state_abs["opt"], mesh),
             "step": ()}
    return state_abs, SH.shardings(specs, state_abs, mesh)


def reshard_checkpoint(ckpt_dir: str, step: int, cfg, opt,
                       new_mesh) -> Tuple[Any, dict]:
    """Load step ``step`` (written from any mesh, or none) placed for
    ``new_mesh``: (state of DTensors, extra)."""
    state_abs, placements = train_state_shardings(cfg, opt, new_mesh)
    return ckpt_lib.restore_resharded(ckpt_dir, step, state_abs, placements,
                                      new_mesh)
