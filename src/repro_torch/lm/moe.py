"""Mixture-of-Experts channel mixing (port of ``repro/lm/moe.py``, its
single-device ``ref`` implementation).

``ref`` runs every expert on every token and zeroes the gates outside
each token's top-k: exact (no capacity drops), O(E) FLOPs.  The
reference's distributed dispatches (``ep_psum``, ``ep_a2a``, ``tp``, with
their capacity buffers) need a device mesh; they wait for multi-GPU
(ROADMAP.md, queue 1 item 7) and raise ``NotImplementedError`` here.

Float steps follow the reference's: the router runs in float32, the
gates are renormalized with ``+ 1e-9``, ``_act``'s GELU is the tanh
approximation (``jax.nn.gelu``'s default), the dense gates come from a
scatter-add and the combine contracts the experts' outputs in float32.
``lax.top_k`` puts the lower expert first among equal probabilities; a
stable descending sort does the same here.  Expert weights stay exact
(``model.radixify_params`` leaves a dict holding ``router`` as it is).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.lm.config import ArchConfig, MoEConfig

__all__ = ["moe_ffn", "router_aux_loss", "pick_impl", "expert_outputs",
           "IMPLS"]

IMPLS = ("auto", "ref", "ep_psum", "ep_a2a", "tp")
DISTRIBUTED = ("ep_psum", "ep_a2a", "tp")


def pick_impl(cfg: ArchConfig) -> str:
    """The dispatch of ``cfg.moe.impl``: ``"auto"`` on one device is
    ``"ref"``.  The distributed dispatches raise ``NotImplementedError``
    (multi-GPU, ROADMAP.md item 7)."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name} has no MoE layers")
    if m.impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {m.impl!r} (one of {IMPLS})")
    if m.impl in DISTRIBUTED:
        raise NotImplementedError(
            f"MoE dispatch {m.impl!r} over a device mesh is not ported yet "
            "(ROADMAP.md, queue 1 item 7: multi-GPU); use impl='ref'")
    return "ref"


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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig):
    """Routed experts (shared experts are the caller's): x (B, S, d) ->
    (y (B, S, d), aux loss)."""
    pick_impl(cfg)
    return _moe_ref(x, p, cfg)
