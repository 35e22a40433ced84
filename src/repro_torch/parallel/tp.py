"""Tensor parallelism over the 'model' axis: each 'model' rank holds and
computes its shard of every dense layer, laid out by the reference's
``PartitionSpec``s (``parallel/sharding.py``), with the collectives where
GSPMD puts them for the reference.

:func:`shard_params` cuts a parameter tree (DTensors placed by
``sharding.param_specs``, or whole tensors) to this rank's pieces over
'model' (the data axes gathered, or kept in a train step) and returns
them with a :class:`TP`, the layout the layers read: per weight its
``sharding.model_split`` kind.
The layers (``lm/blocks.py``, ``lm/radix.py``, ``lm/model.py``) then run
Megatron's scheme:

* a **column**-parallel product (output channels or heads over 'model')
  takes the whole input and gives this rank's output channels;
* a **row**-parallel product takes this rank's slice of the input and
  gives a partial sum, summed over 'model' (:meth:`TP.exit`); a radix
  product sums its int32 accumulators, exactly;
* the residual stream between blocks is whole on every rank, or with
  ``cfg.seq_shard`` in train and prefill split over the sequence
  (Megatron-SP, the reference's ``_resid_spec``): :meth:`TP.enter`
  all-gathers it into a block and :meth:`TP.exit` reduce-scatters the
  block's output;
* a weight that no split divides is used whole by every rank
  (``"replicated"``): its input's gradient is scaled by 1/model
  (:meth:`TP.replicated`), so that the sum over ranks on the way out of
  the block counts it once.

The gradient rules are Megatron's (``collectives.py``): a replicated
parameter used on a piece of the work (a norm under sequence
parallelism, RWKV's token-shift mixes) gets its gradient summed over
'model' (:meth:`TP.param`); one used on replicated work keeps the whole
gradient every rank computed.

In a train step (``shard_params(..., keep_data=True)``) a DTensor leaf
also keeps its piece over the data axes ('pod', 'data'), where the rule
table splits d_model (the reference's FSDP, ZeRO-3 under GSPMD); the
:class:`TP` records each such leaf's data-split dim (``TP.data``) and
:meth:`TP.over_data` gathers a layer's pieces where the layer runs
(``collectives.fsdp_gather``: backward, the data ranks' gradients
reduce-scattered back to the piece), so the step's gradients and
optimizer work on the pieces.  The MoE experts keep their 'model' piece
then (kind ``"expert"``): this rank's experts or d_ff slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH
from repro_torch.train.tree import leaves_with_paths, unflatten

__all__ = ["TP", "shard_params", "model_size"]

MODEL = ("model",)


def model_size(mesh) -> int:
    """The mesh's 'model' axis size (1 without one, or without a mesh)."""
    if mesh is None:
        return 1
    return SH.axis_sizes(mesh).get("model", 1)


def _weight_names(names: Tuple[str, ...]) -> Tuple[str, ...]:
    """A leaf's weight path: a radix dict's ``q``/``qt``/``scale`` leaf
    names its weight."""
    return names[:-1] if names and names[-1] in SH.RADIX_KEYS else names


def _layer_key(names: Tuple[str, ...]) -> Tuple[str, ...]:
    """The layer-relative key of a weight path (``segments`` and
    ``enc_segments`` layers share their layout)."""
    if names and names[0] in ("segments", "enc_segments"):
        return names[1:]
    return names


@dataclasses.dataclass(frozen=True)
class TP:
    """The 'model' layout of one call: the mesh, the split kind of each
    weight (keyed by its layer-relative path), whether the residual
    stream is split over the sequence (``seq``), the path prefix of the
    block that holds it (:meth:`at`), whether the block's KV cache
    holds this rank's piece of its slots (``kv_split``), and in a train
    step (``data`` not None) each leaf that keeps its piece over the data
    axes: ``{tree path: (split dim, data axes)}``."""

    mesh: object
    kinds: Dict[Tuple[str, ...], str]
    seq: bool = False
    prefix: Tuple[str, ...] = ()
    kv_split: bool = False
    data: Optional[Dict[Tuple, Tuple[int, Tuple[str, ...]]]] = None

    @property
    def n(self) -> int:
        return model_size(self.mesh)

    @property
    def rank(self) -> int:
        return C.group_rank(self.mesh, MODEL)

    def at(self, *prefix: str) -> "TP":
        return dataclasses.replace(self, prefix=self.prefix + prefix)

    def with_seq(self, seq: bool) -> "TP":
        return dataclasses.replace(self, seq=seq)

    def with_kv_split(self, kv_split: bool) -> "TP":
        return dataclasses.replace(self, kv_split=kv_split)

    def kind(self, *key: str) -> str:
        return self.kinds.get(self.prefix + key, "replicated")

    # -- activations ------------------------------------------------------

    def enter(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """A block's input, whole on this rank: all-gathered over the
        sequence under ``seq``; the backward sums the ranks' partial
        gradients."""
        if self.seq:
            return C.seq_gather(x, dim, self.mesh, MODEL)
        return C.copy_to(x, self.mesh, MODEL)

    def exit(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """A row-parallel partial sum summed over 'model' (this rank's
        sequence piece of it under ``seq``)."""
        if self.seq:
            return C.seq_scatter(y, dim, self.mesh, MODEL)
        return C.reduce_from(y, self.mesh, MODEL)

    def exit_whole(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The exit of a block every rank computed whole: its sequence
        piece under ``seq`` (the backward all-gathers), else ``y``."""
        if self.seq:
            return C.slice_of(y, dim, self.mesh, MODEL)
        return y

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The input of work every rank repeats whole: forward identity,
        backward the gradient / model, so that :meth:`enter`'s sum over
        the ranks counts it once."""
        return _ScaleGrad.apply(x, 1.0 / self.n) if self.n > 1 else x

    def param(self, p: torch.Tensor) -> torch.Tensor:
        """A replicated parameter used on this rank's piece of the work:
        its gradient summed over 'model'."""
        return C.copy_to(p, self.mesh, MODEL)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Pieces joined into the whole every rank then uses alike
        (backward: this rank's slice)."""
        return C.gather_from(x, dim, self.mesh, MODEL)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Pieces joined into a whole that each rank uses for its own
        part of the work (backward: the ranks' partial gradients summed,
        then this rank's slice)."""
        return C.seq_gather(x, dim, self.mesh, MODEL)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Partial sums summed over 'model', whole on every rank (backward
        the identity)."""
        return C.reduce_from(y, self.mesh, MODEL)

    def piece(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of a whole ``x`` (backward: all-gather)."""
        return C.slice_of(x, dim, self.mesh, MODEL)

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk j of ``x``'s dim 0 sent to rank j; chunk i of the result
        came from rank i (backward: the reverse exchange)."""
        return C.all_to_all(x, self.mesh, MODEL)

    def sum_int(self, x: torch.Tensor, scatter_dim=None) -> torch.Tensor:
        return C.sum_int(x, self.mesh, MODEL, scatter_dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return C.max_over(x, self.mesh, MODEL)

    # -- parameters over the data axes ------------------------------------

    def over_data(self, tree, *prefix, layer: bool = False):
        """``tree``, the parameters' subtree at path ``prefix``, whole
        over the data axes for the work at hand: a leaf kept split over
        them all-gathered (``collectives.fsdp_gather``; ``layer``: the
        leaves are one layer's slices of stacked leaves, the split dim
        one lower), a leaf stored whole over them entered with
        ``collectives.fsdp_copy`` (its gradient summed over them).  The
        identity outside a train step (``data`` None)."""
        if self.data is None:
            return tree
        dp = SH.dp_axes(self.mesh)

        def one(path, leaf):
            hit = self.data.get(tuple(prefix) + path)
            if hit is None:
                return C.fsdp_copy(leaf, self.mesh, dp)
            dim, axes = hit
            return C.fsdp_gather(leaf, dim - int(layer), self.mesh, axes)

        return unflatten(tree, [one(p, t) for p, t in leaves_with_paths(tree)])


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _model_only(spec) -> tuple:
    """``spec`` kept to its 'model' entries."""
    return tuple(e if e is not None and "model" in SH.entry_axes(e) else None
                 for e in spec)


def _data_only(spec, mesh) -> tuple:
    dp = set(SH.dp_axes(mesh))
    return tuple(e if e is not None and set(SH.entry_axes(e)) <= dp
                 and SH.entry_axes(e) else None for e in spec)


def _kmajor_view(t, fn):
    """``fn`` applied to the (…, d_in, d_out) view of a K-major
    (…, d_out, d_in) ``qt`` and the result made K-major again."""
    return fn(t.transpose(-1, -2)).transpose(-1, -2).contiguous()


def _local_leaf(t, names, cfg, mesh, kind: str, spec) -> torch.Tensor:
    """This rank's piece over 'model' of the whole leaf ``t`` at
    ``names`` (a float weight, or a radix dict's ``q``/``qt``/``scale``)
    whose weight splits as ``(kind, spec)`` (:func:`SH.model_split`)."""
    last = names[-1]
    if kind in ("replicated", "whole"):
        return t
    if last not in SH.RADIX_KEYS:
        return SH.local_slice(t, spec, mesh)
    key, hd = names[-2], cfg.hd
    if last == "scale":               # (…, d_out): follows the out channels
        if kind in ("row", "row_hd"):
            return t
        if kind == "head_dim":
            v = t.reshape(t.shape[:-1] + (-1, hd))
            return SH.local_slice(v, (None,) * (v.ndim - 1) + ("model",),
                                  mesh).reshape(t.shape[:-1] + (-1,))
        return SH.local_slice(t, (None,) * (t.ndim - 1) + ("model",), mesh)

    def cut(q):                       # (…, d_in, d_out) levels
        fshape = SH._float_shape(key, q.shape, hd)
        v = SH.local_slice(q.reshape(fshape), spec[-len(fshape):], mesh)
        if key in ("wq", "wk", "wv"):
            return v.reshape(v.shape[:-2] + (-1,))
        if key == "wo":
            return v.reshape(v.shape[:-3] + (-1, v.shape[-1]))
        return v

    if last == "qt":
        return _kmajor_view(t, cut)
    return cut(t).contiguous()


def _local_dtensor(t, mesh):
    """A DTensor's piece over 'model' and its spec, the data axes
    gathered (no communication where they hold one rank)."""
    spec = SH.spec_of(t)
    want = _model_only(spec)
    sizes = SH.axis_sizes(mesh)
    if all(sizes[a] == 1 for e in _data_only(spec, mesh)
           for a in SH.entry_axes(e)):
        return t.to_local(), want
    return t.redistribute(mesh, SH.placements(want, mesh)).to_local(), want


def _data_entry(spec, mesh) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dim, axes) of the entry of ``spec`` that splits a leaf over the
    data axes, None where none does.  An entry must split over every
    data axis of more than one rank, or over none, and not share its dim
    with 'model' (``ValueError``): the step's sums over the data axes
    count each piece once."""
    sizes = SH.axis_sizes(mesh)
    dp = SH.dp_axes(mesh)
    live = {a for a in dp if sizes[a] > 1}
    hit = None
    for d, e in enumerate(spec):
        axes = SH.entry_axes(e)
        mine = tuple(a for a in axes if a in dp)
        if not mine:
            continue
        if "model" in axes or hit is not None or \
                {a for a in mine if sizes[a] > 1} not in (set(), live):
            raise ValueError(f"spec {spec!r}: a leaf splits over the data "
                             f"axes {dp} on one dim at most, over each of "
                             "them of more than one rank, never with "
                             "'model'")
        hit = (d, mine)
    return hit


def _data_piece(leaf, mesh, kind: str):
    """A DTensor leaf's piece as a train step keeps it: over the data
    axes as stored (with its :func:`_data_entry`), over 'model' as
    ``kind`` uses it (gathered for a ``"whole"`` leaf)."""
    spec = SH.spec_of(leaf)
    piece = leaf.to_local()
    if kind == "whole":
        for d, e in enumerate(spec):
            if "model" in SH.entry_axes(e):
                piece = C.gather_from(piece, d, mesh, MODEL)
    return piece, _data_entry(spec, mesh)


def shard_params(params, cfg, mesh, *, contiguous: bool = False,
                 keep_data: bool = False):
    """(this rank's pieces of ``params`` over 'model', :class:`TP`).

    A DTensor leaf is gathered over the data axes only; a leaf the rule
    table splits over 'model' keeps its piece (a radix dict's levels,
    stored whole by the table, are cut here, locally).  A ``"whole"``
    leaf, the MoE experts (which the mesh dispatches slice themselves)
    and a weight's scale under a row split are gathered whole.  Whole
    (non-DTensor) leaves are cut locally, with no communication.
    ``contiguous`` copies each piece into its own storage (a deployment
    cutting its weights once, the K-major levels of a row split
    included), so the whole tree can be freed.

    ``keep_data`` (a train step) keeps each float DTensor leaf's piece
    over the data axes too, recorded in ``TP.data`` for
    :meth:`TP.over_data`, and the MoE experts' piece over 'model' (kind
    ``"expert"``; whole leaves are cut to it locally).  Radix leaves,
    which only serving uses, are cut as without it."""
    from torch.distributed.tensor import DTensor

    kinds: Dict[Tuple[str, ...], str] = {}
    data = {} if keep_data else None
    out = []
    for path, leaf in leaves_with_paths(params):
        names = SH._names_of(path)
        wnames = _weight_names(names)
        fshape = tuple(leaf.shape)
        if names[-1] in ("q", "qt"):
            q_shape = fshape if names[-1] == "q" else (
                fshape[:-2] + (fshape[-1], fshape[-2]))
            fshape = SH._float_shape(wnames[-1], q_shape, cfg.hd)
        if names[-1] == "scale":        # follows its weight's levels
            kind, spec = kinds[_layer_key(wnames)], None
        else:
            kind, spec = SH.model_split(wnames, fshape, cfg, mesh)
            if kind == "expert" and not keep_data:
                kind = "whole"
            kinds[_layer_key(wnames)] = kind
        if (isinstance(leaf, DTensor) and keep_data
                and names[-1] not in SH.RADIX_KEYS):
            piece, entry = _data_piece(leaf, mesh, kind)
            if entry is not None:
                data[path] = entry
            out.append(piece)
            continue
        if isinstance(leaf, DTensor):
            piece, have = _local_dtensor(leaf, mesh)
            split = any(e is not None for e in have)
            if split and kind != "whole" and names[-1] not in SH.RADIX_KEYS:
                out.append(piece)       # the rule's piece, as stored
                continue
            if split:                   # used whole, or a radix leaf
                piece = C.gather_from(piece, have.index("model"), mesh,
                                         MODEL)
            leaf = piece
        out.append(_local_leaf(leaf, names, cfg, mesh, kind, spec))
    if contiguous:
        out = [t.contiguous().clone() if torch.is_tensor(t) else t
               for t in out]
    return unflatten(params, out), TP(mesh, kinds, data=data)
