"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/parallel/pipeline.py``; default axis 'pod').

Layers are split into ``n_stages`` contiguous stages, one per rank of
the axis; microbatches stream through them, each stage handing its
output to the next with :func:`collectives.permute` (the reference's
``lax.ppermute``), and the GPipe bubble of ``n_stages - 1`` ticks shows
up in the tick loop: every stage runs its layers on every tick, the
bubble's ticks on zeros.

The schedule is the reference's, run eagerly on each rank: stage 0
takes microbatch ``t - stage`` (zeros outside ``[0, n_micro)``), the
other stages the inter-stage register; the last stage writes its
finished microbatch; the register shifts one stage on; at the end the
finished microbatches are summed over the axis (``reduce_from``: every
stage but the last holds zeros), so every stage returns all of them.
Each selection is a ``torch.where`` on a scalar condition, as the
reference's ``jnp.where``: a value it does not pick still joins the
autograd graph with a zero gradient, so every rank runs the same
backward, each permute's reverse shift matched on every rank.  The
shift after the last tick, whose result nothing reads, is not sent.

Scope, as the reference's: homogeneous layer stacks (one block
function for every layer).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import axis_sizes
from repro_torch.train.tree import leaves, tree_map, unflatten

__all__ = ["gpipe", "unstack"]


def _stage_params(stacked_params, mesh, axis: str, n_stages: int):
    """This stage's ``(L / n_stages, ...)`` slice of every stacked leaf:
    a DTensor's local piece (it must be placed ``Shard(0)`` on ``axis``
    and replicated elsewhere), or a slice of a whole tensor whose
    gradient is gathered over ``axis`` (every rank then holds the whole
    gradient)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    order = list(axis_sizes(mesh))

    def local(t):
        if t.shape[0] % n_stages:
            raise ValueError(f"a stacked leaf of {t.shape[0]} layers does "
                             f"not split over {n_stages} stages")
        if isinstance(t, DTensor):
            want = tuple(Shard(0) if a == axis else Replicate()
                         for a in order)
            if tuple(t.placements) != want:
                raise ValueError(f"a stacked DTensor leaf must be placed "
                                 f"{want}, got {tuple(t.placements)}")
            return t.to_local()
        return C.slice_of(t, 0, mesh, (axis,))

    return tree_map(local, stacked_params)


def unstack(stacked) -> list:
    """A tree of stacked ``(L, ...)`` leaves -> the L per-layer trees
    (one ``unbind`` a leaf)."""
    per_leaf = [t.unbind(0) for t in leaves(stacked)]
    return [unflatten(stacked, [p[j] for p in per_leaf])
            for j in range(len(per_leaf[0]) if per_leaf else 0)]


def gpipe(block_fn: Callable, mesh, axis: str = "pod"):
    """Build a pipelined layer-stack applier.

    ``block_fn(params_one_layer, x) -> x`` applies one layer.  Returns
    ``apply(stacked_params, x_micro)`` where

      stacked_params : leaves (L, ...) with L = n_stages * layers_per_stage
                       in stage-major order, whole or DTensors placed
                       ``Shard(0)`` on ``axis``
      x_micro        : (n_micro, mb, ...) microbatches, the same on every
                       rank of ``axis``

    and the result, on every stage, is all L layers applied to every
    microbatch.  Every rank of ``mesh`` calls ``apply``.
    """
    n_stages = axis_sizes(mesh)[axis]
    stage = mesh.get_local_rank(axis)
    last = n_stages - 1

    def apply(stacked_params, x_micro):
        n_micro = x_micro.shape[0]
        layers = unstack(_stage_params(stacked_params, mesh, axis, n_stages))

        def run_stage(h):
            for lp in layers:
                h = block_fn(lp, h)
            return h

        def flag(cond: bool):
            return torch.tensor(cond, device=x_micro.device)

        zeros = torch.zeros_like(x_micro[0])
        buf = zeros                                  # inter-stage register
        outs = [zeros] * n_micro
        ticks = n_micro + n_stages - 1
        for t in range(ticks):
            mb = t - stage                           # microbatch index here
            valid = 0 <= mb < n_micro
            slot = min(max(mb, 0), n_micro - 1)
            x_in = torch.where(flag(valid), x_micro[slot], zeros)
            h_out = run_stage(torch.where(flag(stage == 0), x_in, buf))
            # the last stage writes its finished microbatch
            outs[slot] = torch.where(flag(stage == last and valid), h_out,
                                     outs[slot])
            if t < ticks - 1:                        # shift to the next stage
                buf = C.permute(h_out, mesh, axis, shift=1)
        # every stage but the last holds zeros: the sum replicates the
        # finished microbatches to every stage
        return C.reduce_from(torch.stack(outs), mesh, (axis,))

    return apply
