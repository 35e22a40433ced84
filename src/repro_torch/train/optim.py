"""Optimizers (port of ``repro/train/optim.py``): SGD (+momentum), Adam,
Adafactor, over trees of tensors.

The reference's functional API::

    opt = adam(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

State NamedTuples keep the reference's names, fields and dtypes (Adam's
``mu``/``nu`` float32, SGD's momentum in the parameter's dtype,
Adafactor's momentum bfloat16), so checkpoint keys match across the two
packages.  Float steps follow the reference's, with JAX's type promotion:
a bfloat16 gradient times a float32 tensor is float32 (``g * scale`` in
:func:`clip_by_global_norm`; torch would keep a 0-d float32 operand's
result bfloat16, so the gradient is cast first), a host scalar times a
bfloat16 tensor is rounded to bfloat16 first (SGD's ``-lr * g``), and
every division by a host scalar divides by a float32 tensor on the
operand's device (CUDA turns a host-scalar divisor into a reciprocal
multiply).

``shards`` (a :class:`Shards`, or a sequence of them: one per group of
ranks, as the data axes and 'model') runs an update on leaves split over
groups of ranks (ZeRO-3 and tensor parallelism: each rank holding its
piece of a parameter, its gradient and its state): the global norm sums
each leaf's partial sum over every group that splits it, Adafactor's
factored row and column statistics over the groups that split the dim
they reduce, its RMS clip over every group that splits the leaf, so
every rank updates its piece as the whole update would (in another
float order).  Adam and SGD are elementwise and take it unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.train.tree import leaves, tree_map

__all__ = ["Optimizer", "sgd", "adam", "adafactor", "apply_updates",
           "global_norm", "clip_by_global_norm", "AdamState",
           "AdafactorState", "Shards"]

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


class Shards(NamedTuple):
    """Leaves split over a group of ``n`` ranks: ``dims`` a tree like the
    parameters' of each leaf's split dim (-1: the leaf is whole on every
    rank of the group), ``sum`` a tensor summed over the group (the sum
    returned)."""
    dims: Any
    n: int
    sum: Callable[[torch.Tensor], torch.Tensor]


def _groups(shards) -> tuple:
    """``shards`` (None, a :class:`Shards` or a sequence of them) as a
    tuple of :class:`Shards`."""
    if shards is None:
        return ()
    return (shards,) if isinstance(shards, Shards) else tuple(shards)


def _split_sum(x: torch.Tensor, dim: int, keepdim: bool,
               split) -> torch.Tensor:
    """``x.sum(dim)`` of a leaf split as ``split`` says (pairs of a
    :class:`Shards` and the leaf's split dim over it, -1 none): summed
    over each group that splits ``dim``."""
    out = x.sum(dim=dim, keepdim=keepdim)
    for sh, d in split:
        if d >= 0 and dim % x.ndim == d:
            out = sh.sum(out.contiguous())
    return out


def _split_mean(x, dim: int, keepdim: bool, split) -> torch.Tensor:
    """``x.mean(dim)``; where groups split ``dim``, the sum over them
    divided by the whole length."""
    ns = [sh.n for sh, d in split if d >= 0 and dim % x.ndim == d]
    if not ns:
        return x.mean(dim=dim, keepdim=keepdim)
    return _div(_split_sum(x, dim, keepdim, split),
                float(x.shape[dim] * math.prod(ns)))


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with a host scalar ``a`` or ``b`` as a float32 tensor on
    the other operand's device."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=F32, device=b.device)
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=F32, device=a.device)
    return a / b


def _mul(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c * t`` with the host scalar ``c`` first rounded to ``t``'s dtype,
    as JAX's weak typing does (torch multiplies a bfloat16 tensor by an
    unrounded float32 scalar)."""
    return torch.tensor(c, dtype=t.dtype, device=t.device) * t


def _device(tree) -> torch.device:
    ls = [x for x in leaves(tree) if torch.is_tensor(x)]
    return ls[0].device if ls else torch.device("cpu")


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the leaves' float32 sums of squares, summed in leaf order
    (a split leaf's sum summed over each group of ``shards`` that splits
    it first: one sum of the split leaves' sums a group, in the groups'
    order)."""
    sums = [torch.sum(torch.square(x.to(F32))) for x in leaves(tree)]
    for sh in _groups(shards):
        split = [d >= 0 for d in leaves(sh.dims)]
        if sums and any(split):
            vec = torch.stack([t if s else torch.zeros_like(t)
                               for t, s in zip(sums, split)])
            vec = sh.sum(vec)
            sums = [v if s else t for t, v, s in zip(sums, vec, split)]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads, max_norm: float, shards=None):
    norm = global_norm(grads, shards)
    scale = torch.clamp(_div(max_norm, norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, F32)) * scale,
                    grads), norm


# ---------------------------------------------------------------------------


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None, shards=None):
        del params, shards          # elementwise
        if momentum == 0.0:
            return tree_map(lambda g: _mul(-lr, g), grads), state
        new_m = tree_map(lambda m, g: _mul(momentum, m) + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: _mul(-lr, _mul(momentum, m) + g),
                           new_m, grads)
        else:
            upd = tree_map(lambda m: _mul(-lr, m), new_m)
        return upd, new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
        )

    def update(grads, state: AdamState, params=None, shards=None):
        del shards                  # elementwise
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(F32)),
                      state.nu, grads)
        bc1 = 1 - b1 ** step.to(F32)
        bc2 = 1 - b2 ** step.to(F32)

        def u(m, v, p):
            # in place on fresh temporaries: the same values, one leaf-sized
            # buffer fewer (Gemma-2B's Adam step peaks near the card's size)
            denom = torch.sqrt(v / bc2).add_(eps)
            upd = (m / bc1).mul_(-lr).div_(denom)
            if weight_decay and p is not None:
                upd = upd - lr * weight_decay * p.to(F32)
            return upd

        if params is None:
            updates = tree_map(lambda m, v: u(m, v, None), mu, nu)
        else:
            updates = tree_map(u, mu, nu, params)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor: factored second moments.
# ---------------------------------------------------------------------------


class _FactoredSlot(NamedTuple):
    vr: torch.Tensor     # row statistics  (shape[:-1])
    vc: torch.Tensor     # col statistics  (shape[:-2] + shape[-1:])


class AdafactorState(NamedTuple):
    step: torch.Tensor
    slots: Any           # per-leaf _FactoredSlot, or full nu for <2-D leaves
    mu: Any              # momentum (bf16), or () when disabled


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, momentum: Optional[float] = None,
              momentum_dtype=torch.bfloat16) -> Optimizer:
    """Adafactor with relative steps off (explicit lr), optional bf16
    momentum.  Factored leaves store O(r + c) statistics."""

    def init(params):
        def slot(p):
            if _factored(p.shape):
                return _FactoredSlot(
                    vr=torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                    vc=torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                   device=p.device))
            return torch.zeros_like(p, dtype=F32)

        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype),
                       params) if momentum else ())
        return AdafactorState(
            torch.zeros((), dtype=torch.int32, device=_device(params)),
            tree_map(slot, params), mu)

    def update(grads, state: AdafactorState, params=None, shards=None):
        step = state.step + 1
        beta = 1.0 - (step.to(F32) + 1.0) ** -decay

        groups = _groups(shards)

        def upd_leaf(g, s, *ds):
            split = list(zip(groups, ds))
            g = g.to(F32)
            g2 = torch.square(g) + eps
            if isinstance(s, _FactoredSlot):
                nd = g.ndim
                vr = beta * s.vr + (1 - beta) * _split_mean(
                    g2, -1, False, split)
                vc = beta * s.vc + (1 - beta) * _split_mean(
                    g2, -2, False, split)
                # vr is g's shape[:-1]: its last dim is g's dim nd - 2
                denom = _split_mean(vr, -1, True, [
                    (sh, d if d == nd - 2 else -1) for sh, d in split])
                rms = ((vr / torch.clamp_min(denom, eps))[..., None]
                       * vc[..., None, :])
                precond = g * torch.rsqrt(torch.clamp_min(rms, eps))
                new_s = _FactoredSlot(vr, vc)
            else:
                nu = beta * s + (1 - beta) * g2
                precond = g * torch.rsqrt(torch.clamp_min(nu, eps))
                new_s = nu
            # update clipping (Adafactor's RMS clip)
            sq = torch.square(precond)
            live = [sh for sh, d in split if d >= 0]
            if live:
                tot = torch.sum(sq).reshape(1)
                for sh in live:
                    tot = sh.sum(tot)
                msq = _div(tot[0], float(sq.numel()
                                         * math.prod(sh.n for sh in live)))
            else:
                msq = torch.mean(sq)
            rms_u = torch.sqrt(msq + 1e-12)
            precond = precond / torch.clamp_min(_div(rms_u, clip_threshold),
                                                1.0)
            return -lr * precond, new_s

        pairs = tree_map(upd_leaf, grads, state.slots,
                         *(sh.dims for sh in groups))
        updates = tree_map(lambda g, p: p[0], grads, pairs)
        slots = tree_map(lambda g, p: p[1], grads, pairs)

        mu = state.mu
        if momentum:
            mu = tree_map(lambda m, u: (momentum * m.to(F32) + u)
                          .to(momentum_dtype), state.mu, updates)
            updates = tree_map(lambda m: m.to(F32), mu)
        return updates, AdafactorState(step, slots, mu)

    return Optimizer(init, update)
