"""Mixture-of-Experts channel mixing (port of ``repro/lm/moe.py``).

Four interchangeable dispatches (``MoEConfig.impl``; ``"auto"`` picks by
mesh, :func:`pick_impl`):

* ``ref``     -- every expert on every token, gates zeroed outside each
                 token's top-k: exact (no capacity drops), O(E) FLOPs.
                 The correctness oracle of the other three.
* ``ep_psum`` -- experts split over 'model'; every model rank routes the
                 whole (replicated) batch shard to its own experts, and
                 an all-reduce sums the ranks' contributions.
* ``ep_a2a``  -- tokens split over 'model' along the sequence; each rank
                 routes its tokens, ``all_to_all`` sends the capacity
                 buffers to the experts' owners and back.
* ``tp``      -- fewer experts than model ranks: each expert's d_ff split
                 over 'model', a local capacity dispatch, an all-reduce
                 of the partial outputs.

The mesh dispatches bound each expert's tokens by capacity
(``capacity_factor``; GShard-style drops).  ``_dispatch`` keeps the
reference's stable sort and ``searchsorted`` slots, so its integer
metadata is exact; ``_combine`` adds each token's k outputs in the order
the reference's ``.at[st].add`` applies them.

In a train step a mesh dispatch gets this model rank's experts or d_ff
slice (``local=True``; split kind ``"expert"``), gathered over the data
axes for the layer where the reference all-gathers its FSDP weight
shards (``_gathered_weights``; here ``parallel/tp.TP.over_data`` in
``lm/model._backbone``), so each expert's gradient is this rank's own,
reduce-scattered back over the data axes to the piece the rank stores.
Serving hands it the experts whole (``tp.shard_params`` gathers them)
and :func:`_local_weights` takes the rank's share; its backward
all-gathers the slice's gradient, so every rank ends with the whole
gradient.  The router, the shared experts and every dense layer follow
the dense rules of ``parallel/tp.py`` (``lm/model._apply_layer``).  The
collectives and their gradients are ``parallel/collectives.py``'s.

Float steps follow the reference's: the router runs in float32, the
gates are renormalized with ``+ 1e-9``, ``_act``'s GELU is the tanh
approximation (``jax.nn.gelu``'s default), ``ref``'s dense gates come
from a scatter-add and its combine contracts the experts' outputs in
float32.  ``lax.top_k`` puts the lower expert first among equal
probabilities; a stable descending sort does the same here.  Expert
weights stay exact (``model.radixify_params`` leaves a dict holding
``router`` as it is).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.lm.config import ArchConfig, MoEConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import axis_sizes, dp_axes

__all__ = ["moe_ffn", "router_aux_loss", "pick_impl", "dp_axes",
           "expert_outputs", "IMPLS"]

IMPLS = ("auto", "ref", "ep_psum", "ep_a2a", "tp")
MODEL = ("model",)


def pick_impl(cfg: ArchConfig, mesh=None, decode: bool = False) -> str:
    """The dispatch of ``cfg.moe.impl``; ``"auto"`` is ``"ref"`` without
    a 'model' axis of more than one rank, ``"tp"`` when the experts do
    not divide it, else ``"ep_psum"`` for decode (S == 1 cannot split
    over 'model') and ``"ep_a2a"`` otherwise.  A mesh dispatch named
    with ``mesh=None`` raises ``ValueError`` (the reference fails there
    with an ``AttributeError`` on ``mesh.shape``)."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name} has no MoE layers")
    if m.impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {m.impl!r} (one of {IMPLS})")
    if m.impl != "auto":
        if m.impl != "ref" and mesh is None:
            raise ValueError(f"MoE dispatch {m.impl!r} runs over a device "
                             "mesh; pass mesh= (or impl='ref')")
        return m.impl
    model = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if model == 1:
        return "ref"
    if m.num_experts % model:
        return "tp"
    return "ep_psum" if decode else "ep_a2a"


def _act(cfg: ArchConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(g) * u
    return F.gelu(g, approximate="tanh") * u


def _router(x: torch.Tensor, wr: torch.Tensor, m: MoEConfig):
    """x (n, d) -> top-k (gates (n, k) f32 renormalized, idx (n, k) int64,
    probs (n, E) f32)."""
    logits = x.to(torch.float32) @ wr.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates, idx, probs


def router_aux_loss(probs: torch.Tensor, idx: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * <f_e * p_e>."""
    lead = tuple(range(probs.ndim - 1))
    me = probs.mean(dim=lead)                                   # <p_e>
    onehot = F.one_hot(idx, num_experts).to(torch.float32)
    fe = onehot.sum(-2).mean(dim=lead)                          # routed share
    fe = fe / torch.clamp(fe.sum(), min=1e-9)
    return num_experts * torch.sum(me * fe)


def expert_outputs(x2: torch.Tensor, p: dict, cfg: ArchConfig
                   ) -> torch.Tensor:
    """Every expert on every token: x2 (n, d) -> (E, n, d), the
    reference's ``einsum("nef,efd->ned")`` laid out expert-major.  Batched
    products over the stacked (E, d, f) weights as they are stored (a
    broadcast token batch, no copy of the weights)."""
    xb = x2.unsqueeze(0)                                        # (1, n, d)
    h = torch.matmul(xb, p["w_gate"])                           # (E, n, f)
    u = torch.matmul(xb, p["w_up"])
    return torch.matmul(_act(cfg, h, u), p["w_down"])           # (E, n, d)


def _moe_ref(x: torch.Tensor, p: dict, cfg: ArchConfig):
    """Dense reference: every expert on every token."""
    m = cfg.moe
    b, s_len, d = x.shape
    x2 = x.reshape(-1, d)
    n = x2.shape[0]
    gates, idx, probs = _router(x2, p["router"], m)
    y_all = expert_outputs(x2, p, cfg)                          # (E, n, d)
    dense = torch.zeros((n, m.num_experts), dtype=torch.float32,
                        device=x.device).scatter_add_(1, idx, gates)
    # einsum("ned,ne->nd") as (n, 1, E) @ (n, E, d) in float32
    y = torch.bmm(dense[:, None, :],
                  y_all.to(torch.float32).transpose(0, 1))[:, 0]
    aux = router_aux_loss(probs, idx, m.num_experts)
    return y.reshape(b, s_len, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Capacity dispatch (per rank, fixed shapes).
# ---------------------------------------------------------------------------


def _dispatch(x2, idx, gates, e_lo: int, e_hi: int, cap: int):
    """Scatter tokens into per-expert capacity buffers.

    x2 (n, d); idx/gates (n, k).  Experts [e_lo, e_hi) are handled here.
    Returns buf (E_loc, cap, d) and the combine's metadata (slot expert
    ``be``, slot ``bc`` (``cap`` for a dropped entry), ``keep``, token
    ``st``, gate ``sg``), each over the n * k entries sorted stably by
    local expert."""
    n, k = idx.shape
    dev = idx.device
    e_loc = e_hi - e_lo
    flat_e = idx.reshape(-1) - e_lo                            # (n*k,)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    valid = (flat_e >= 0) & (flat_e < e_loc)
    order = torch.argsort(torch.where(valid, flat_e, e_loc), stable=True)
    se, st, sg, sv = flat_e[order], flat_t[order], flat_g[order], valid[order]
    starts = torch.searchsorted(torch.where(sv, se, e_loc),
                                torch.arange(e_loc, device=dev))
    pos = torch.arange(n * k, device=dev) - starts[se.clamp(0, e_loc - 1)]
    keep = sv & (pos < cap)
    be = torch.where(keep, se, 0)
    bc = torch.where(keep, pos, cap)                           # cap: dropped
    buf = torch.zeros((e_loc, cap + 1, x2.shape[1]), dtype=x2.dtype,
                      device=x2.device)
    buf = buf.index_put((be, bc), x2[st] * keep[:, None].to(x2.dtype),
                        accumulate=True)
    return buf[:, :cap], (be, bc, keep, st, sg)


def _combine(y_buf, meta, n: int):
    """Gather the expert outputs back to token order, weighted by gates:
    each token's k entries summed from zero in the order they stand in
    ``meta`` (the order ``.at[st].add`` applies its updates)."""
    be, bc, keep, st, sg = meta
    y_buf = F.pad(y_buf, (0, 0, 0, 1))                         # slot cap = 0
    vals = y_buf[be, bc] * (sg * keep)[:, None].to(y_buf.dtype)
    per = vals[torch.argsort(st, stable=True)].reshape(n, -1, vals.shape[-1])
    out = torch.zeros((n, vals.shape[-1]), dtype=y_buf.dtype,
                      device=y_buf.device)
    for j in range(per.shape[1]):
        out = out + per[:, j]
    return out


def _expert_ffn(buf, wg, wu, wd, cfg: ArchConfig):
    """(E, cap, d) x (E, d, f) -> (E, cap, d)."""
    g = torch.matmul(buf, wg)
    u = torch.matmul(buf, wu)
    return torch.matmul(_act(cfg, g, u), wd)


def _local_weights(p: dict, mesh, tp: bool = False, local: bool = False):
    """This model rank's expert weights from the gathered (E, d, f) /
    (E, f, d) stacks: its experts (``ep_*``) or every expert's d_ff slice
    (``tp``).  Backward all-gathers the slice's gradient over 'model'.
    ``local``: ``p`` holds them already."""
    if local:
        return p["w_gate"], p["w_up"], p["w_down"]
    if tp:
        return (C.slice_of(p["w_gate"], 2, mesh, MODEL),
                C.slice_of(p["w_up"], 2, mesh, MODEL),
                C.slice_of(p["w_down"], 1, mesh, MODEL))
    return tuple(C.slice_of(p[k], 0, mesh, MODEL)
                 for k in ("w_gate", "w_up", "w_down"))


def _replicated_aux(aux, mesh, split_over_model: bool):
    """The router loss averaged over every rank (the reference's
    ``pmean``).  Its gradient reaches each rank's share once: divided by
    the model ranks when the tokens were split over them."""
    sizes = axis_sizes(mesh)
    return C.mean_over(aux, mesh, tuple(sizes), grad_scale=(
        1.0 / sizes["model"] if split_over_model else 1.0))


def _capacity(n_loc: int, m: MoEConfig) -> int:
    return max(1, math.ceil(n_loc * m.top_k / m.num_experts
                            * m.capacity_factor))


def _moe_over_model(x, p, cfg: ArchConfig, mesh, tp: bool,
                    local: bool = False):
    """``ep_psum`` (this model rank's E / ep experts) or ``tp`` (every
    expert's d_ff slice): each model rank routes the whole batch shard,
    dispatches it locally by capacity, and the ranks' partial outputs
    are summed (the reference's ``psum``)."""
    m = cfg.moe
    e_loc = m.num_experts if tp else (m.num_experts
                                      // axis_sizes(mesh)["model"])
    # local expert ids are global ids offset by rank * E_loc (ep_psum)
    lo = 0 if tp else mesh.get_local_rank("model") * e_loc
    b, s_len, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, probs = _router(x2, p["router"], m)
    wg, wu, wd = _local_weights(p, mesh, tp=tp, local=local)
    buf, meta = _dispatch(C.copy_to(x2, mesh, MODEL), idx - lo,
                          C.copy_to(gates, mesh, MODEL), 0, e_loc,
                          _capacity(x2.shape[0], m))
    y = _combine(_expert_ffn(buf, wg, wu, wd, cfg), meta, x2.shape[0])
    y = C.reduce_from(y.to(x.dtype), mesh, MODEL)
    aux = router_aux_loss(probs, idx, m.num_experts)
    return y.reshape(b, s_len, d), _replicated_aux(aux, mesh, False)


def _moe_ep_a2a(x, p, cfg: ArchConfig, mesh, local: bool = False):
    """Tokens split over 'model' along the sequence; ``all_to_all``
    expert dispatch."""
    m = cfg.moe
    ep = axis_sizes(mesh)["model"]
    e_loc = m.num_experts // ep
    b, s_len, d = x.shape
    if s_len % ep:
        raise ValueError(f"ep_a2a splits the sequence over 'model': "
                         f"{s_len} positions over {ep} ranks")
    x_r = C.slice_of(x, 1, mesh, MODEL)                         # (b, S/ep, d)
    x2 = x_r.reshape(-1, d)
    gates, idx, probs = _router(x2, C.copy_to(p["router"], mesh, MODEL), m)
    wg, wu, wd = _local_weights(p, mesh, local=local)
    cap = _capacity(x2.shape[0], m)
    # capacity buffers for ALL experts, grouped by owner rank
    buf, meta = _dispatch(x2, idx, gates, 0, m.num_experts, cap)
    recv = C.all_to_all(buf.reshape(ep, e_loc * cap, d), mesh, MODEL)
    recv = recv.reshape(ep, e_loc, cap, d).transpose(0, 1)
    y_buf = _expert_ffn(recv.reshape(e_loc, ep * cap, d), wg, wu, wd, cfg)
    y_buf = y_buf.reshape(e_loc, ep, cap, d).transpose(0, 1)
    back = C.all_to_all(y_buf.reshape(ep, e_loc * cap, d), mesh, MODEL)
    y = _combine(back.reshape(m.num_experts, cap, d), meta, x2.shape[0])
    y = C.gather_from(y.to(x.dtype).reshape(b, s_len // ep, d), 1, mesh,
                      MODEL)
    aux = router_aux_loss(probs, idx, m.num_experts)
    return y, _replicated_aux(aux, mesh, True)


_IMPL_FNS = {
    "ep_psum": lambda x, p, cfg, mesh, local: _moe_over_model(
        x, p, cfg, mesh, False, local),
    "ep_a2a": _moe_ep_a2a,
    "tp": lambda x, p, cfg, mesh, local: _moe_over_model(
        x, p, cfg, mesh, True, local)}


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, mesh=None, *,
            decode: bool = False, local: bool = False):
    """Routed experts (shared experts are the caller's): x (B, S, d) ->
    (y (B, S, d), aux loss).  With a mesh, ``x`` is this rank's batch
    shard, the same on every model rank of its data group, and so is
    ``y``; the aux loss is the mean over every rank.  ``local``: ``p``
    holds this model rank's experts or d_ff slice (a train step's),
    not every expert whole."""
    impl = pick_impl(cfg, mesh, decode)
    if impl == "ref":
        return _moe_ref(x, _whole_weights(p, cfg, mesh) if local else p, cfg)
    return _IMPL_FNS[impl](x, p, cfg, mesh, local)


def _whole_weights(p: dict, cfg: ArchConfig, mesh) -> dict:
    """``p`` with this model rank's share of the experts (split as the
    rule table splits them: the experts where they divide 'model', else
    d_ff) joined into every expert whole (backward: the rank's slice)."""
    if cfg.moe.num_experts % axis_sizes(mesh).get("model", 1) == 0:
        dims = {"w_gate": 0, "w_up": 0, "w_down": 0}
    else:
        dims = {"w_gate": 2, "w_up": 2, "w_down": 1}
    return dict(p, **{k: C.gather_from(p[k], d, mesh, MODEL)
                      for k, d in dims.items()})
