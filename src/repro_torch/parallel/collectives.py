"""Collectives over the axes of a ``DeviceMesh``, with the gradients the
port's sharded steps need.

Inside a sharded step every rank of one data group computes the same
replicated activations, and a part of the work (a MoE layer's experts or
d_ff slice, ``lm/moe.py``) is split over 'model'.  The loss is one value
per data group, held by each of its model ranks, so the autograd rules
are Megatron's, not a plain transpose (which would count the loss once
per model rank):

* :func:`copy_to` (a replicated value entering split work): forward
  identity, backward all-reduce (sum) of the ranks' partial gradients;
* :func:`reduce_from` (the split work's partial results summed, the
  reference's ``psum``): forward all-reduce, backward identity;
* :func:`slice_of` (a replicated value cut to this rank's piece):
  forward slice, backward all-gather, so every rank holds the whole
  gradient;
* :func:`gather_from` (pieces joined into a replicated value): forward
  all-gather, backward this rank's slice;
* :func:`all_to_all` (equal splits along dim 0; the reference's
  ``all_to_all(..., tiled=True)``): backward is the reverse exchange;
* :func:`mean_over` (the reference's ``pmean``): forward all-reduce over
  the group and divide by its size, backward the gradient times
  ``grad_scale``;
* :func:`permute` (the reference's ``ppermute`` by a fixed shift along
  one axis): forward each rank sends to the rank ``shift`` places on and
  receives from the one ``shift`` places back, backward the reverse
  shift of the gradient;
* :func:`seq_gather` / :func:`seq_scatter` (Megatron-SP's entry to and
  exit from the tensor-parallel region, the residual stream split over
  the sequence): forward all-gather along a dim, backward reduce-scatter
  of the ranks' partial gradients; forward reduce-scatter of the ranks'
  partial sums, backward all-gather;
* :func:`sum_int` and :func:`max_over` (no gradient: the integer
  accumulators of a row-parallel radix product, summed exactly, and a
  per-token or per-head scale whose absmax is split over the ranks);
* :func:`fsdp_gather` / :func:`fsdp_copy` (ZeRO-3 over the data axes: a
  parameter piece split over them all-gathered where it is used,
  backward the data ranks' gradients reduce-scattered back to the
  piece; a parameter whole over them, backward its gradient summed
  over them) and :func:`sum_fixed` (a sum with no gradient: the loss,
  the metrics and the optimizer's partial sums).  These three add the
  ranks' contributions in one fixed order, rank 0 first, in float32:
  one all-to-all hands each rank every rank's chunk of its piece, which
  it adds up itself, so every rank gets the same bits for a piece on
  any backend.

A group of one rank skips its communication (every function is then the
identity, or a slice of the whole).  Gloo moves CUDA tensors through the
host (its own CUDA support covers only some collectives), so every
function runs on gloo and NCCL alike; gloo has no reduce-scatter, which
is an all-reduce and this rank's chunk there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import axis_sizes

__all__ = ["group", "group_size", "group_rank", "copy_to", "reduce_from",
           "slice_of", "gather_from", "all_to_all", "mean_over",
           "permute", "all_reduce_", "seq_gather", "seq_scatter",
           "sum_int", "max_over", "fsdp_gather", "fsdp_copy",
           "sum_fixed"]


def group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` (several axes: the
    flattened sub-mesh, ranks in mesh order).  ``None`` for no axes."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    from torch.utils._python_dispatch import _disable_current_modes

    # the sub-mesh is host bookkeeping on real tensors: outside any
    # dispatch mode (a fake one would refuse them)
    with _disable_current_modes():
        return mesh[axes]._flatten().get_group()


def group_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def group_rank(mesh, axes: Sequence[str]) -> int:
    """This rank's index in the group over ``axes`` (mesh order)."""
    sizes = axis_sizes(mesh)
    k = 0
    for a in axes:
        k = k * sizes[a] + mesh.get_local_rank(a)
    return k


def _gloo(pg) -> bool:
    return dist.get_backend(pg) == "gloo"


def _gather(x: torch.Tensor, dim: int, pg, n: int) -> torch.Tensor:
    if x.is_cuda and _gloo(pg):
        return _gather(x.cpu(), dim, pg, n).to(x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat(parts, dim)


def _chunk(x: torch.Tensor, dim: int, n: int, k: int) -> torch.Tensor:
    return x.chunk(n, dim)[k].contiguous()


def all_reduce_(x: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over ``pg`` in place by ``op`` (default a sum; no-op
    for ``None``); returns x."""
    if pg is None:
        return x
    if x.is_cuda and _gloo(pg):
        x.copy_(all_reduce_(x.cpu(), pg, op))
        return x
    dist.all_reduce(x, op=op, group=pg)
    return x


def _reduce_scatter(x: torch.Tensor, dim: int, pg, n: int,
                    k: int) -> torch.Tensor:
    """This rank's chunk ``k`` along ``dim`` of ``x`` summed over ``pg``."""
    if _gloo(pg):
        return _chunk(all_reduce_(x.contiguous().clone(), pg), dim, n, k)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=pg)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_fixed(x: torch.Tensor, dim: int, pg, n: int
                          ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x`` summed over ``pg``: one
    all-to-all brings every rank's chunk here, added in rank order in
    float32 and rounded once to ``x``'s dtype."""
    if x.is_cuda and _gloo(pg):
        return _reduce_scatter_fixed(x.cpu(), dim, pg, n).to(x.device)
    xm = x.movedim(dim, 0).contiguous()
    recv = torch.empty_like(xm)
    dist.all_to_all_single(recv, xm, group=pg)
    parts = recv.chunk(n, 0)
    out = parts[0].to(torch.float32)
    for p in parts[1:]:
        out = out + p.to(torch.float32)
    return out.to(x.dtype).movedim(0, dim).contiguous()


def _all_reduce_fixed(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """``x`` summed over ``pg`` as :func:`_reduce_scatter_fixed` adds a
    chunk, the chunks then all-gathered: the same bits on every rank."""
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    whole = _gather(_reduce_scatter_fixed(flat, 0, pg, n), 0, pg, n)
    return whole[:x.numel()].reshape(x.shape)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.pg), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return all_reduce_(x.contiguous().clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg, n, k):
        ctx.dim, ctx.pg, ctx.n = dim, pg, n
        return _chunk(x, dim, n, k)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.pg, ctx.n), None, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg, n, k):
        ctx.dim, ctx.n, ctx.k = dim, n, k
        return _gather(x, dim, pg, n)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.n, ctx.k), None, None, None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg, n, k):
        ctx.dim, ctx.pg, ctx.n, ctx.k = dim, pg, n, k
        return _gather(x, dim, pg, n)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.dim, ctx.pg, ctx.n, ctx.k), None,
                None, None, None)


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg, n, k):
        ctx.dim, ctx.pg, ctx.n = dim, pg, n
        return _reduce_scatter(x, dim, pg, n, k)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.pg, ctx.n), None, None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg, n):
        ctx.dim, ctx.pg, ctx.n = dim, pg, n
        return _gather(x, dim, pg, n)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_fixed(g, ctx.dim, ctx.pg, ctx.n), None, None,
                None)


class _FsdpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n):
        ctx.pg, ctx.n = pg, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fixed(g, ctx.pg, ctx.n), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _exchange(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.pg), None


def _exchange(x: torch.Tensor, pg) -> torch.Tensor:
    if x.is_cuda and _gloo(pg):
        return _exchange(x.cpu(), pg).to(x.device)
    # a strided gradient's empty_like keeps its strides: the exchange
    # writes dense chunks
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=pg)
    return out


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, grad_scale):
        ctx.grad_scale = grad_scale
        total = all_reduce_(x.contiguous().clone(), pg)
        return total / torch.tensor(float(n), dtype=x.dtype, device=x.device)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None


def _shift(x: torch.Tensor, pg, send_to: int, recv_from: int):
    """Send ``x`` to global rank ``send_to`` and receive a tensor like it
    from ``recv_from``, as one batch of point-to-point operations."""
    if x.is_cuda and _gloo(pg):
        return _shift(x.cpu(), pg, send_to, recv_from).to(x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group=pg),
           dist.P2POp(dist.irecv, out, recv_from, group=pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, send_to, recv_from):
        ctx.pg, ctx.send_to, ctx.recv_from = pg, send_to, recv_from
        return _shift(x, pg, send_to, recv_from)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.pg, ctx.recv_from, ctx.send_to), None, None, None


def _axes_info(mesh, axes) -> Tuple[Optional[object], int, int]:
    n = group_size(mesh, axes)
    if n == 1:
        return None, 1, 0
    return group(mesh, axes), n, group_rank(mesh, axes)


def copy_to(x, mesh, axes):
    pg, n, _ = _axes_info(mesh, axes)
    return x if n == 1 else _CopyTo.apply(x, pg)


def reduce_from(x, mesh, axes):
    pg, n, _ = _axes_info(mesh, axes)
    return x if n == 1 else _ReduceFrom.apply(x, pg)


def slice_of(x, dim: int, mesh, axes):
    pg, n, k = _axes_info(mesh, axes)
    return x if n == 1 else _SliceOf.apply(x, dim, pg, n, k)


def gather_from(x, dim: int, mesh, axes):
    pg, n, k = _axes_info(mesh, axes)
    return x if n == 1 else _GatherFrom.apply(x, dim, pg, n, k)


def all_to_all(x, mesh, axes):
    pg, n, _ = _axes_info(mesh, axes)
    return x if n == 1 else _AllToAll.apply(x, pg)


def mean_over(x, mesh, axes, grad_scale: float = 1.0):
    pg, n, _ = _axes_info(mesh, axes)
    if n == 1:
        return x
    return _MeanOver.apply(x, pg, n, grad_scale)


def permute(x, mesh, axis: str, shift: int = 1):
    """``x`` of the rank ``shift`` places back along ``axis`` (cyclic), as
    the reference's ``ppermute`` with pairs ``(i, (i + shift) % n)``.
    Every rank of the axis's group must call it; a group of one rank
    returns ``x`` itself."""
    pg, n, k = _axes_info(mesh, (axis,))
    if n == 1:
        return x
    send_to = dist.get_global_rank(pg, (k + shift) % n)
    recv_from = dist.get_global_rank(pg, (k - shift) % n)
    return _Permute.apply(x, pg, send_to, recv_from)


def seq_gather(x, dim: int, mesh, axes):
    """Megatron-SP's entry: the ranks' pieces along ``dim`` joined (every
    rank then computes its own part of the work on the whole); backward,
    the ranks' partial gradients summed and cut back to the piece."""
    pg, n, k = _axes_info(mesh, axes)
    return x if n == 1 else _SeqGather.apply(x, dim, pg, n, k)


def seq_scatter(x, dim: int, mesh, axes):
    """Megatron-SP's exit: the ranks' partial sums summed and cut to this
    rank's piece along ``dim``; backward, the pieces' gradients joined."""
    pg, n, k = _axes_info(mesh, axes)
    return x if n == 1 else _SeqScatter.apply(x, dim, pg, n, k)


def sum_int(x: torch.Tensor, mesh, axes, scatter_dim=None) -> torch.Tensor:
    """The integer ``x`` summed over ``axes`` (exact: no rounding in any
    order), or with ``scatter_dim`` this rank's piece of the sum along
    it.  No gradient."""
    pg, n, k = _axes_info(mesh, axes)
    if n == 1:
        return x
    if scatter_dim is not None:
        return _reduce_scatter(x.detach(), scatter_dim, pg, n, k)
    return all_reduce_(x.detach().contiguous().clone(), pg)


def max_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (exact).  No
    gradient."""
    pg, n, _ = _axes_info(mesh, axes)
    if n == 1:
        return x
    return all_reduce_(x.detach().contiguous().clone(), pg,
                       dist.ReduceOp.MAX)


def fsdp_gather(x, dim: int, mesh, axes):
    """ZeRO-3's gather: the data ranks' pieces of a parameter along
    ``dim`` joined where it is used; backward, the ranks' gradients of
    the whole summed (rank order, float32) and cut back to this rank's
    piece.  The identity over a group of one rank."""
    pg, n, _ = _axes_info(mesh, axes)
    return x if n == 1 else _FsdpGather.apply(x, dim, pg, n)


def fsdp_copy(x, mesh, axes):
    """A parameter whole over ``axes`` used on this data rank's batch:
    forward the identity, backward its gradient summed over the group
    (rank order, float32; the same bits on every rank)."""
    pg, n, _ = _axes_info(mesh, axes)
    return x if n == 1 else _FsdpCopy.apply(x, pg, n)


def sum_fixed(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` in rank order (float32; the same bits
    on every rank).  No gradient."""
    pg, n, _ = _axes_info(mesh, axes)
    if n == 1:
        return x
    return _all_reduce_fixed(x.detach(), pg, n)
