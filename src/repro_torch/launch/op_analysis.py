"""Per-device cost of one call, from the ops it dispatches (the port's
counterpart of ``repro/launch/hlo_analysis.py``).

Torch emits no HLO: :func:`analyze` runs the call once under a
``TorchDispatchMode`` that counts every aten and c10d op as it is
dispatched, with the reference's cost model:

* FLOPs: ``mm``/``bmm``/``addmm``/``baddbmm``/``_int_mm`` 2 * prod(out) *
  contracted; a convolution 2 * out elements * Cin/groups * kh * kw; an
  op tagged ``torch.Tag.pointwise`` one flop per output element;
* bytes: operands plus outputs of each op (the 'every op round-trips
  HBM' traffic model).  Views, factory ops (no tensor input) and
  ``prim.device`` count nothing; a gather (``index``, ``index_select``,
  ``gather``, ``embedding``) reads and writes its slice and reads its
  indices; an update in place (``copy_``, ``fill_``, ``index_put_``,
  ``index_copy_``, ``scatter_``) writes the update and reads its other
  operands, not the buffer it writes into;
* collectives: per-device link bytes under the ring model, ``g`` the
  group's size::

    all-gather          (g-1) * local in
    reduce-scatter      (g-1)/g * in
    all-reduce          2 * (g-1)/g * in
    all-to-all          (g-1)/g * in
    collective-permute  in            (the send of ``collectives.permute``)

  over both families: the in-place c10d ops (``c10d.allreduce_`` ...,
  their group a ``ProcessGroup`` argument) and the functional ones
  (``_c10d_functional.all_gather_into_tensor`` ..., their group named);
* the radix kernels, which ``ctypes`` hides from any dispatch mode,
  note their work themselves (``kernels/work.py``): each call counts
  once, by its own reckoning, whichever implementation runs, and the
  aten ops of a plain version inside it count nothing.

Eager torch unrolls every loop, so where ``HloCost`` lists loop trip
counts :class:`OpCost` counts ops by name.  A DTensor op is counted at
the local shapes its rank computes: the mode declines it, and DTensor's
local ops and the collectives of its redistributions reach the mode.
DTensor's sharding propagation, which runs the op once more at global
shapes on fake or meta tensors, counts nothing, and neither does any op
on a meta tensor: analyze placeholders made under ``FakeTensorMode``
(on "cpu"), not meta tensors.  Every number is per device (per rank).

Beside the counts, :func:`analyze` records ``FlopCounterMode``'s total
over the same call (``raw_flops``, the library's own count, as the
reference records ``cost_analysis()``) and the peak bytes of tensors the
call made and held at once (``peak_bytes``), tracked by their storages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import work as work_lib

__all__ = ["OpCost", "analyze"]


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    raw_flops: Optional[float] = None
    peak_bytes: float = 0.0


_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "_int_mm"}
_GATHERS = {"index", "index_select", "gather", "embedding"}
_OVERWRITES = {"copy_", "fill_", "zero_"}            # the whole view written
_UPDATES = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_"}

# op -> (collective, position of its input tensors); the group is the
# op's ProcessGroup argument (c10d) or the name it ends with (functional)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    """The tensors in ``x`` (a tensor or nested lists/tuples of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _link_bytes(kind: str, g: int, in_b: float) -> float:
    if kind == "all-gather":
        return (g - 1) * in_b
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * in_b
    if kind in ("reduce-scatter", "all-to-all"):
        return (g - 1) / g * in_b
    return in_b                                    # collective-permute


def _group_size(func, args) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if func.namespace == "c10d":
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        return dist.ProcessGroup.unbox(pg).size()
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _aliases(func) -> bool:
    """The op returns a view of an input (no bytes of its own)."""
    return func.is_view or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


class _Analysis(TorchDispatchMode):
    """Counts the ops dispatched while it is active into ``cost``;
    nothing while ``muted`` (a noted kernel call, sharding
    propagation)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.cost = OpCost()
        self.muted = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0

    # -- kernel notes (kernels/work.noted) ---------------------------------

    def note(self, w: work_lib.Work) -> None:
        if self.muted:
            return
        c = self.cost
        c.flops += w.ops
        c.bytes += w.nbytes
        c.ops[w.kernel] = c.ops.get(w.kernel, 0) + 1

    def made(self, out) -> None:
        """Track the storages of a noted call's result."""
        for t in _tensors(out):
            self._track(t)

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = n = st.nbytes()
        self._live_bytes += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # its local ops come back here
        out = func(*args, **kwargs)
        if self.muted or any(t.device.type == "meta"
                             for t in _tensors((args, kwargs))):
            return out
        for t in _tensors(out):
            self._track(t)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._opname
        key = f"{func.namespace}.{name}"
        c.ops[key] = c.ops.get(key, 0) + 1
        ns = func.namespace
        if ns == "c10d" and name in _C10D:
            kind, pos = _C10D[name]
            in_b = _nbytes(args[pos])
            self._collective(kind, _group_size(func, args), in_b,
                             0.0 if kind == "collective-permute"
                             else _nbytes(args[0]))
            return
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            self._collective(_FUNCTIONAL[name], _group_size(func, args),
                             _nbytes(args[0]), _nbytes(out))
            return
        if ns in ("c10d", "_c10d_functional"):
            c.bytes += _nbytes((args, out))        # recv_, waits, barriers
            return
        ins = list(_tensors((args, kwargs)))
        if not ins or not list(_tensors(out)) or _aliases(func):
            return           # a factory op, a view, or no tensor made
        if name in _OVERWRITES:
            c.bytes += _nbytes(ins[1:]) + _nbytes(ins[0])
            return
        if name in _UPDATES:
            c.bytes += 2.0 * _nbytes(ins[-1]) + _nbytes(ins[1:-1])
            return
        if name in _GATHERS:
            idx = [t for t in ins if not t.is_floating_point()
                   and t.dtype != torch.bool]
            c.bytes += 2.0 * _nbytes(out) + _nbytes(idx[-1:])
        else:
            c.bytes += _nbytes(ins) + _nbytes(out)
        c.flops += self._flops(func, name, args, out)

    def _collective(self, kind: str, g: int, in_b: float,
                    out_b: float) -> None:
        c = self.cost
        link = _link_bytes(kind, g, in_b)
        c.collective_bytes += link
        c.per_collective[kind] = c.per_collective.get(kind, 0.0) + link
        c.bytes += in_b + out_b

    @staticmethod
    def _flops(func, name: str, args, out) -> float:
        outs = list(_tensors(out))
        if not outs:
            return 0.0
        if name in _MATMULS:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            return 2.0 * outs[0].numel() * a.shape[-1]
        if name == "convolution":
            return 2.0 * outs[0].numel() * math.prod(args[1].shape[1:])
        if torch.Tag.pointwise in func.tags:
            return float(outs[0].numel())
        return 0.0


@contextlib.contextmanager
def _mute_propagation(mode: _Analysis):
    """Mute ``mode`` while DTensor propagates shardings (which runs each
    op again at global shapes)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        yield
        return
    orig = getattr(ShardingPropagator, name)

    def muted(self, *a, **k):
        mode.muted += 1
        try:
            return orig(self, *a, **k)
        finally:
            mode.muted -= 1

    setattr(ShardingPropagator, name, muted)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def analyze(fn, *args, **kwargs) -> Tuple[object, OpCost]:
    """Run ``fn(*args, **kwargs)`` once and return (its result, the
    per-device :class:`OpCost` of the ops it dispatched)."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = _Analysis()
    counter = FlopCounterMode(display=False)
    with _mute_propagation(mode), counter, mode:
        work_lib._SINKS.append(mode)
        try:
            result = fn(*args, **kwargs)
        finally:
            work_lib._SINKS.remove(mode)
    mode.cost.raw_flops = float(counter.get_total_flops())
    return result, mode.cost
