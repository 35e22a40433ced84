"""Model construction: init / train / prefill / decode from an ArchConfig
(port of ``repro/lm/model.py`` on one device).

Public surface (functions of param and cache trees):

    init_params(generator, cfg, device=)   real parameters, seeded
    abstract_params(cfg, mode)             their shapes and dtypes, no memory
    radixify_params(params, cfg)           paper-technique serving weights
    kmajor_params(params)                  their levels in the kernel's layout
    forward_train(params, batch, cfg, mesh)  -> logits, labels, aux
    loss_fn(params, batch, cfg, mesh)        -> loss, metrics
    make_train_step(cfg, opt, clip_norm, mesh=) -> step(state, batch)
    init_cache(cfg, batch, max_len, device=)
    abstract_cache(cfg, batch, max_len, mode)
    prefill(params, batch, cfg, mesh, max_len=, true_len=) -> logits, caches
    decode_step(params, caches, tokens, pos, cfg, mesh)   -> logits, caches

The trees keep the reference's layout: ``params["segments"]`` is a tuple
over layer segments of a tuple over pattern slots of dicts whose leaves
are stacked ``(count, ...)``; caches mirror it.  Where the reference scans
over a segment, the port loops over its layers in Python.  ``decode_step``
writes the new token's K/V and every recurrent state into ``caches`` in
place and returns the same trees (see ``lm/radix.py``).

Block types: ``attn``, ``local_attn`` (a ring-buffer cache of ``window``
slots), ``rglru`` and ``rwkv6``, with the dense FFNs, RWKV's channel mix
or MoE experts (``lm/moe.py``, the single-device ``ref`` dispatch, plus
shared experts); RoPE, M-RoPE, learned or no position embedding; token
or embedding inputs (``batch["embeds"]``); and Whisper's encoder-decoder:
a non-causal encoder over ``batch["enc_embeds"]`` and a cross-attention
step in every decoder layer, whose cache is ``{"self", "cross"}``.
Training takes gradients by autograd through the same blocks (the
reference has ``jax.value_and_grad``); ``cfg.remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``).

``mesh=None`` is one device.  With a ``DeviceMesh`` ('data', 'model',
optionally 'pod'; ``launch/mesh.py``) the functions run on every rank of
it: each data rank computes its own batch shard, and the ranks of one
data group split every dense layer over 'model' as the reference's
``PartitionSpec``s lay it out (``parallel/tp.py``: column- and
row-parallel products, attention heads or head_dim, RG-LRU's width,
RWKV-6's heads or key dim; ``lm/blocks.py``).  In train and prefill the
residual stream between blocks is split over the sequence when
``cfg.seq_shard`` and the length divides 'model' (the reference's
``_constrain`` / ``_resid_spec``, Megatron-SP); decode keeps it whole.
A MoE layer's experts run through its mesh dispatch (``lm/moe.py``).
Parameters and caches may be DTensors placed by ``parallel/sharding.py``'s
specs, or whole tensors.  Serving uses each rank's pieces over 'model',
the data axes gathered (``tp.shard_params``; :func:`shard` cuts them once
for a deployment); the KV cache stays split over its slots on 'model',
decode merges the ranks' attention states (flash-decoding), and the
logits are gathered whole.  Training keeps each DTensor leaf's piece over
the data axes too (ZeRO-3): a layer's pieces are gathered where it runs
and its gradients reduce-scattered back (:func:`make_train_step`), and
the loss is computed on this rank's vocab columns where the head splits
the vocab over 'model' (:func:`loss_fn`).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch._subclasses.fake_tensor import is_fake

from repro_torch import trace
from repro_torch.api import _resolve_device
from repro_torch.lm import blocks, moe as moe_lib, radix as radix_lib
from repro_torch.lm.config import ArchConfig, segments_for
from repro_torch.lm.radix import torch_dtype
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tp as tp_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import tree as tree_lib
from repro_torch.train.tree import tree_map

__all__ = ["init_params", "abstract_params", "radixify_params",
           "kmajor_params", "forward_train", "loss_fn", "make_train_step",
           "init_cache", "abstract_cache", "prefill", "decode_step",
           "shard", "Sharded", "tree_map"]


def _stack_trees(trees):
    """A list of same-structure trees -> one tree of stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_trees([t[i] for t in trees])
                            for i in range(len(first)))
    return torch.stack(trees)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


BLOCK_TYPES = ("attn", "local_attn", "rglru", "rwkv6")
ACTS = ("swiglu", "geglu", "gelu_mlp", "relu_sq")
POS_EMBEDS = ("rope", "learned", "none")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for what no reference arch has: an unknown
    block type, activation, position embedding or MoE dispatch."""
    bad = sorted(set(cfg.layer_types) - set(BLOCK_TYPES))
    if bad:
        raise ValueError(f"unknown block types {bad} (known: "
                         f"{BLOCK_TYPES})")
    if cfg.act not in ACTS:
        raise ValueError(f"unknown act {cfg.act!r} (known: {ACTS})")
    if cfg.pos_embed not in POS_EMBEDS:
        raise ValueError(f"unknown pos_embed {cfg.pos_embed!r} (known: "
                         f"{POS_EMBEDS})")
    if cfg.moe is not None and cfg.moe.impl not in moe_lib.IMPLS:
        raise ValueError(f"unknown MoE impl {cfg.moe.impl!r} (known: "
                         f"{moe_lib.IMPLS})")


# ---------------------------------------------------------------------------
# Initialization.
# ---------------------------------------------------------------------------


_DRAW_ELEMS = 1 << 26         # float32 elements a draw's transient holds


def _nrm(gen: torch.Generator, shape, scale: float, dtype, device):
    """N(0, scale^2) in ``dtype``: each trailing matrix drawn in float32
    by its own ``normal_`` call (the draw's values depend on it), scaled
    and cast a group of matrices at a time, the group's float32
    transient at most ``_DRAW_ELEMS`` elements or one matrix (Grok-1's
    stacked experts are 25.8 GB in float32 at 4 layers)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if is_fake(out) or out.is_meta:     # no values to draw
        return out
    mats = out.view((-1,) + tuple(shape[-2:])) if len(shape) > 2 else out[None]
    per = max(1, min(len(mats), _DRAW_ELEMS // max(1, mats[0].numel())))
    buf = torch.empty((per,) + tuple(mats.shape[1:]), dtype=torch.float32,
                      device=device)
    for i in range(0, len(mats), per):
        group = buf[:min(per, len(mats) - i)]
        for m in group.unbind(0):
            m.normal_(generator=gen)
        mats[i:i + len(group)].copy_(group.mul_(scale))
    return out


def _init_norm(cfg: ArchConfig, count: int, device):
    shape = (count, cfg.d_model)
    if cfg.norm == "layernorm":
        return {"w": torch.ones(shape, device=device),
                "b": torch.zeros(shape, device=device)}
    if cfg.norm == "gemma_rmsnorm":
        return {"w": torch.zeros(shape, device=device)}  # scale 1 + w
    return {"w": torch.ones(shape, device=device)}


def _init_attn(gen, cfg: ArchConfig, c: tuple, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, s_in = _dt(cfg), d ** -0.5
    return {
        "wq": _nrm(gen, c + (d, h, hd), s_in, dt, device),
        "wk": _nrm(gen, c + (d, hkv, hd), s_in, dt, device),
        "wv": _nrm(gen, c + (d, hkv, hd), s_in, dt, device),
        "wo": _nrm(gen, c + (h, hd, d), (h * hd * 2 * cfg.n_layers) ** -0.5,
                   dt, device),
    }


def _init_ffn(gen, cfg: ArchConfig, c: tuple, device, d_ff: int = 0
              ) -> dict:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, _dt(cfg)
    s_in, s_out = d ** -0.5, (f * 2 * cfg.n_layers) ** -0.5
    p = {"w_up": _nrm(gen, c + (d, f), s_in, dt, device),
         "w_down": _nrm(gen, c + (f, d), s_out, dt, device)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _nrm(gen, c + (d, f), s_in, dt, device)
    return p


def _init_moe(gen, cfg: ArchConfig, c: tuple, device) -> dict:
    """A float32 router, stacked (E, d, f) / (E, f, d) gated experts and
    the shared experts (one FFN of ``num_shared * d_ff_expert``)."""
    m = cfg.moe
    d, f, e, dt = cfg.d_model, m.d_ff_expert, m.num_experts, _dt(cfg)
    s_in, s_out = d ** -0.5, (f * 2 * cfg.n_layers) ** -0.5
    p = {"router": _nrm(gen, c + (d, e), s_in, torch.float32, device),
         "w_gate": _nrm(gen, c + (e, d, f), s_in, dt, device),
         "w_up": _nrm(gen, c + (e, d, f), s_in, dt, device),
         "w_down": _nrm(gen, c + (e, f, d), s_out, dt, device)}
    if m.num_shared:
        p["shared"] = _init_ffn(gen, cfg, c, device, d_ff=m.num_shared * f)
    return p


def _init_rglru(gen, cfg: ArchConfig, c: tuple, device) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt, f32 = _dt(cfg), torch.float32
    s, sw = d ** -0.5, w ** -0.5
    # lambda_p so that a^8 lies in (0.9, 0.999) at r = 1 (Griffin appendix)
    a8 = torch.rand(c + (w,), generator=gen, dtype=f32, device=device)
    lam = torch.log(torch.expm1(-torch.log(0.9 + 0.099 * a8) / 8.0))
    return {
        "w_gate_branch": _nrm(gen, c + (d, w), s, dt, device),
        "w_rec_in": _nrm(gen, c + (d, w), s, dt, device),
        "conv_w": _nrm(gen, c + (cfg.conv_width, w), 0.25, f32, device),
        "w_a": _nrm(gen, c + (w, w), sw, f32, device),
        "b_a": torch.zeros(c + (w,), device=device),
        "w_x": _nrm(gen, c + (w, w), sw, f32, device),
        "b_x": torch.zeros(c + (w,), device=device),
        "lambda_p": lam,
        "w_out": _nrm(gen, c + (w, d), (w * 2 * cfg.n_layers) ** -0.5, dt,
                      device),
    }


def _init_rwkv6_mix(gen, cfg: ArchConfig, c: tuple, device) -> dict:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = d // hd
    dt, f32 = _dt(cfg), torch.float32
    s = d ** -0.5
    p = {f"mu_{t}": torch.full(c + (d,), 0.5, device=device)
         for t in ("r", "k", "v", "g", "w")}
    p.update({
        "w_r": _nrm(gen, c + (d, d), s, dt, device),
        "w_k": _nrm(gen, c + (d, d), s, dt, device),
        "w_v": _nrm(gen, c + (d, d), s, dt, device),
        "w_g": _nrm(gen, c + (d, d), s, dt, device),
        "w_o": _nrm(gen, c + (d, d), (d * 2 * cfg.n_layers) ** -0.5, dt,
                    device),
        "w_dec_a": _nrm(gen, c + (d, 64), s, f32, device),
        "w_dec_b": _nrm(gen, c + (64, d), 64 ** -0.5, f32, device),
        "w_dec0": torch.zeros(c + (d,), device=device),  # w ~ exp(-1)
        "u_bonus": _nrm(gen, c + (h, hd), 0.5, f32, device),
        "gn_w": torch.ones(c + (h, hd), device=device),
        "gn_b": torch.zeros(c + (h, hd), device=device),
    })
    return p


def _init_rwkv6_cmix(gen, cfg: ArchConfig, c: tuple, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, _dt(cfg)
    return {
        "mu_ck": torch.full(c + (d,), 0.5, device=device),
        "mu_cr": torch.full(c + (d,), 0.5, device=device),
        "w_ck": _nrm(gen, c + (d, f), d ** -0.5, dt, device),
        "w_cv": _nrm(gen, c + (f, d), (f * 2 * cfg.n_layers) ** -0.5, dt,
                     device),
        "w_cr": _nrm(gen, c + (d, d), d ** -0.5, dt, device),
    }


_INIT_MIX = {"attn": _init_attn, "local_attn": _init_attn,
             "rglru": _init_rglru, "rwkv6": _init_rwkv6_mix}


def _init_layers(gen, cfg: ArchConfig, btype: str, count: int, device,
                 cross: bool = False) -> dict:
    """``count`` stacked layers of block type ``btype`` with their channel
    mix (and, for a decoder over an encoder, ``cross``-attention with its
    norm), the reference's shapes, dtypes and init scales."""
    c = (count,)
    if btype == "rwkv6":
        ffn = _init_rwkv6_cmix
    elif cfg.moe is not None:
        ffn = _init_moe
    else:
        ffn = _init_ffn
    p = {"ln1": _init_norm(cfg, count, device),
         "ln2": _init_norm(cfg, count, device),
         "mix": _INIT_MIX[btype](gen, cfg, c, device),
         "ffn": ffn(gen, cfg, c, device)}
    if cross:
        p["lnx"] = _init_norm(cfg, count, device)
        p["xattn"] = _init_attn(gen, cfg, c, device)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device (or on
    ``device``, which must then be the generator's), with the reference's
    tree, shapes, dtypes and init scales (not its bits:
    ``carry.lm_params_from_numpy`` brings those across)."""
    check_supported(cfg)
    device = generator.device if device is None else torch.device(device)
    dt = _dt(cfg)
    p: Dict[str, Any] = {
        "embed": _nrm(generator, (cfg.vocab, cfg.d_model),
                      cfg.d_model ** -0.5, dt, device)}
    p["segments"] = tuple(
        tuple(_init_layers(generator, cfg, btype, count, device,
                           cross=bool(cfg.encoder_layers))
              for btype in pattern)
        for pattern, count in segments_for(cfg))
    p["final_norm"] = _unstacked_norm(cfg, device)
    if not cfg.tie_embeddings:
        p["unembed"] = _nrm(generator, (cfg.d_model, cfg.vocab),
                            cfg.d_model ** -0.5, dt, device)
    if cfg.pos_embed == "learned":
        p["pos_embed"] = _nrm(generator, (cfg.learned_pos_max, cfg.d_model),
                              0.02, dt, device)
    if cfg.encoder_layers:
        p["enc_segments"] = ((_init_layers(generator, cfg, "attn",
                                           cfg.encoder_layers, device),),)
        p["enc_final_norm"] = _unstacked_norm(cfg, device)
        p["enc_pos_embed"] = _nrm(generator, (cfg.encoder_ctx, cfg.d_model),
                                  0.02, dt, device)
    return p


def abstract_params(cfg: ArchConfig, mode) -> dict:
    """:func:`init_params`' tree as fake tensors of ``mode`` (a
    ``FakeTensorMode`` the caller holds) on "cpu": the reference's shapes
    and dtypes, no memory (the reference's ``abstract_params``)."""
    with mode:
        return init_params(torch.Generator(), cfg, device="cpu")


def _unstacked_norm(cfg: ArchConfig, device) -> dict:
    return {k: v[0] for k, v in _init_norm(cfg, 1, device).items()}


def radixify_params(params: dict, cfg: ArchConfig) -> dict:
    """Quantize the serving-path weights (dense FFN matmuls and an untied
    unembed, plus the QKV/out projections under ``cfg.radix_attn``) to
    int8 levels + scales.  Attention projections are stored over their
    flattened 2-D matmul view: wq/wk/wv (..., d, H, hd) -> (..., d, H*hd),
    wo (..., H, hd, d) -> (..., H*hd, d).  MoE experts (a dict holding
    ``router``) and the MoE family's unembed stay exact; shared experts
    and an encoder's FFNs are quantized.  Other leaves are shared."""
    if cfg.quant != "radix":
        return params
    ffn_keys = ("w_gate", "w_up", "w_down")
    attn_keys = ("wq", "wk", "wv", "wo")

    def quant_attn(k, v):
        if k == "wo":
            w2 = v.reshape(v.shape[:-3] + (v.shape[-3] * v.shape[-2],
                                           v.shape[-1]))
        else:
            w2 = v.reshape(v.shape[:-2] + (v.shape[-2] * v.shape[-1],))
        return radix_lib.quantize_weight(w2)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            routed = "router" in tree
            out = {}
            for k, v in tree.items():
                if (k in ffn_keys and torch.is_tensor(v) and "ffn" in path
                        and not routed):
                    out[k] = radix_lib.quantize_weight(v)
                elif (cfg.radix_attn and k in attn_keys
                        and torch.is_tensor(v) and "mix" in path):
                    out[k] = quant_attn(k, v)
                else:
                    out[k] = walk(v, path + (k,))
            return out
        if isinstance(tree, tuple):
            return tuple(walk(v, path) for v in tree)
        return tree

    out = walk(params)
    if not cfg.tie_embeddings and cfg.family != "moe":
        out["unembed"] = radix_lib.quantize_weight(params["unembed"])
    return out


def kmajor_params(params):
    """Every :func:`radixify_params` weight dict with its int8 levels
    K-major (``radix.kmajor_weight``), the radix matmul kernel's layout:
    made once, where a deployment takes its weights, and in place of the
    (d_in, d_out) levels.  Other leaves are shared."""
    if isinstance(params, dict):
        if set(params) == {"q", "scale"}:
            return radix_lib.kmajor_weight(params)
        return {k: kmajor_params(v) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(kmajor_params(v) for v in params)
    return params


# ---------------------------------------------------------------------------
# Layer application.
# ---------------------------------------------------------------------------


def _norm(h, p, cfg: ArchConfig, tp):
    """A pre-norm; under sequence parallelism its parameters see this
    rank's tokens only, so their gradient is summed over 'model'."""
    if tp is not None and tp.seq:
        p = {k: tp.param(v) for k, v in p.items()}
    return blocks.norm(h, p, cfg.norm)


def _kv_piece(k, v, cfg: ArchConfig, length: int, s_len: int, window: int,
              tp):
    """A prefill's whole (B, S, Hkv, hd) K/V as the layer's cache of
    ``length`` slots: the last ``length`` positions of a window, padded
    with zeros, a ring buffer rolled so that position p sits at slot
    p % window, and under ``tp.kv_split`` this rank's piece of the
    slots."""
    if k.shape[1] > length:             # windowed: keep the last positions
        k, v = k[:, -length:], v[:, -length:]
    pad = length - k.shape[1]
    if pad:
        z = torch.zeros((k.shape[0], pad) + tuple(k.shape[2:]),
                        dtype=k.dtype, device=k.device)
        k = torch.cat([k, z], 1)
        v = torch.cat([v, z], 1)
    shift = s_len % length if window and s_len > length else 0
    if shift:
        k, v = torch.roll(k, shift, dims=1), torch.roll(v, shift, dims=1)
    if tp is not None and tp.kv_split:
        n = length // tp.n
        k = k[:, tp.rank * n:(tp.rank + 1) * n]
        v = v[:, tp.rank * n:(tp.rank + 1) * n]
    return k, v


@contextlib.contextmanager
def _ffn_span(device):
    """The ``lm.ffn`` span around one FFN block; its count ``fused`` is the
    block's radix products that took the fused path (``radix.PRODUCTS``)."""
    with trace.span("lm.ffn", device=device) as span:
        before = radix_lib.PRODUCTS["fused"]
        yield
        if span is not None:
            span.counts["fused"] = radix_lib.PRODUCTS["fused"] - before


def _apply_layer(h, lp, btype: str, cfg: ArchConfig, positions, mode: str,
                 cache=None, pos=None, max_len: int = 0, enc_h=None,
                 causal: bool = True, mesh=None, tp=None, kv_split=None,
                 on_state=None):
    """One block: temporal mix (+ cross-attention over the encoder's
    output ``enc_h`` in a layer that has ``xattn``) + channel mix, each
    with its pre-norm and residual.  ``mode="train"`` runs the sequence
    with no cache (``causal=False``: the encoder's attention);
    ``"prefill"`` returns the layer's new cache; ``"decode"`` consumes
    ``cache`` and returns the block's new state (an attention cache is
    updated in place and returned as is).

    Cache structure by block type:
      attn / local_attn : {"k", "v"(, "k_scale", "v_scale")} of length
                          max_len (a ring buffer of min(window, max_len)
                          slots for local_attn)
      rglru             : {"conv": (B, K-1, W), "h": (B, W)}
      rwkv6             : {"mix": {"last_x", "S"}, "cmix": {"last_x"}}
      whisper decoder   : {"self": <attn>, "cross": {"k", "v"}}, the
                          cross K/V float (B, encoder_ctx, Hkv, hd)

    Under ``tp`` (``parallel.tp.TP``: ``lp`` this rank's shards, ``h``
    this rank's tokens under ``tp.seq``) each block runs its share over
    'model'; the caches are this rank's pieces (``kv_split``: per cache
    (``"self"``, ``"cross"``) whether its slots are split over 'model').
    ``on_state(kind, t)``, when given, receives the attention block's
    output (``"attention"``) and the FFN block's (``"ffn"``).
    Returns (h, aux, cache): ``aux`` is a MoE layer's router loss (0.0
    elsewhere), ``cache`` None in train mode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    prefill = mode == "prefill"
    stateful = mode != "train"
    has_x = "xattn" in lp
    kv_split = kv_split or {}
    tmix = tp.at("mix") if tp is not None else None
    hn = _norm(h, lp["ln1"], cfg, tp)
    if tp is not None:
        hn = tp.enter(hn)
    new_mix = None
    if btype in ("attn", "local_attn"):
        window = cfg.window if btype == "local_attn" else 0
        if tmix is not None:
            tmix = tmix.with_kv_split(kv_split.get("self", False))
        if not stateful:
            with trace.span("lm.attention", device=hn.device):
                mix = blocks.attention(hn, lp["mix"], cfg, positions,
                                       window=window, causal=causal, tp=tmix)
        elif prefill:
            with trace.span("lm.attention", device=hn.device):
                mix, (k, v) = blocks.attention(hn, lp["mix"], cfg, positions,
                                               window=window, return_kv=True,
                                               tp=tmix)
            length = min(window, max_len) if window else max_len
            k, v = _kv_piece(k, v, cfg, length, k.shape[1], window, tmix)
            new_mix = radix_lib.encode_cache_bulk(
                k.to(_dt(cfg)), v.to(_dt(cfg)), cfg, _dt(cfg))
        else:
            mix, new_mix = blocks.decode_attention(
                hn, lp["mix"], cfg, cache["self"] if has_x else cache, pos,
                window=window, tp=tmix)
    elif btype == "rglru":
        if stateful:
            mix, new_mix = blocks.rglru_block(
                hn, lp["mix"], cfg, state=None if prefill else cache,
                return_state=True, tp=tmix)
        else:
            mix = blocks.rglru_block(hn, lp["mix"], cfg, tp=tmix)
    elif btype == "rwkv6":
        if stateful:
            mix, new_mix = blocks.rwkv6_block(
                hn, lp["mix"], cfg, state=None if prefill else cache["mix"],
                return_state=True, tp=tmix)
        else:
            mix = blocks.rwkv6_block(hn, lp["mix"], cfg, tp=tmix)
    else:
        raise ValueError(btype)
    if on_state is not None:
        on_state("attention", mix)
    h = h + mix

    if has_x:           # whisper decoder: cross-attention before the FFN
        hx = _norm(h, lp["lnx"], cfg, tp)
        tx = None
        if tp is not None:
            hx = tp.enter(hx)
            tx = tp.at("xattn").with_kv_split(kv_split.get("cross", False))
        if mode == "decode":
            cross = cache["cross"]
            xmix, _ = blocks.decode_attention(hx, lp["xattn"], cfg, cross,
                                              pos, cross=True, tp=tx)
        else:
            # the encoder's output is whole on every rank
            enc = enc_h if tp is None else tp.with_seq(False).enter(enc_h)
            k_enc = blocks._attn_proj(enc, lp["xattn"]["wk"], cfg, tx, "wk")
            v_enc = blocks._attn_proj(enc, lp["xattn"]["wv"], cfg, tx, "wv")
            xmix = blocks.attention(hx, lp["xattn"], cfg, positions,
                                    cross_kv=(k_enc, v_enc), tp=tx,
                                    return_kv=prefill)
            if prefill:
                xmix, (k_enc, v_enc) = xmix
                if tx is not None and tx.kv_split:
                    k_enc, v_enc = _kv_piece(k_enc, v_enc, cfg,
                                             k_enc.shape[1], 0, 0, tx)
            cross = {"k": k_enc.to(_dt(cfg)), "v": v_enc.to(_dt(cfg))}
        h = h + xmix
        if stateful:
            new_mix = {"self": new_mix, "cross": cross}

    hn = _norm(h, lp["ln2"], cfg, tp)
    tffn = tp.at("ffn") if tp is not None else None
    aux = 0.0
    if btype == "rwkv6":
        hn = tp.enter(hn) if tp is not None else hn
        if stateful:
            y, new_cm = blocks.rwkv6_channel_mix(
                hn, lp["ffn"], state=None if prefill else cache["cmix"],
                return_state=True, tp=tffn)
            new_mix = {"mix": new_mix, "cmix": new_cm}
        else:
            y = blocks.rwkv6_channel_mix(hn, lp["ffn"], tp=tffn)
    elif cfg.moe is not None:
        # the mesh dispatches take the whole (replicated) activations
        xm = hn if tp is None or not tp.seq else tp.gather(hn, 1)
        y, aux = moe_lib.moe_ffn(
            xm, lp["ffn"], cfg, mesh, decode=mode == "decode",
            local=tffn is not None and tffn.kind("w_gate") == "expert")
        if tp is not None:
            y = tp.exit_whole(y)
        if cfg.moe.num_shared:
            xs = hn if tp is None else tp.enter(hn)
            with _ffn_span(xs.device):
                y = y + blocks.ffn(
                    xs, lp["ffn"]["shared"], cfg,
                    tp=None if tp is None else tffn.at("shared"))
    else:
        hn = tp.enter(hn) if tp is not None else hn
        with _ffn_span(hn.device):
            y = blocks.ffn(hn, lp["ffn"], cfg, tp=tffn)
    if on_state is not None:
        on_state("ffn", y)
    return h + y, aux, new_mix


def _run_layer(h, lp, btype: str, cfg: ArchConfig, positions, mode: str,
               data_key=None, **kw):
    """:func:`_apply_layer` on ``lp``, this rank's pieces of one layer,
    gathered over the data axes first in a train step (``kw["tp"]``'s
    ``over_data``; ``data_key`` the path of the layer's stacked leaves):
    under ``torch.utils.checkpoint`` the backward gathers them again."""
    tp = kw.get("tp")
    if tp is not None and data_key is not None:
        lp = tp.over_data(lp, *data_key, layer=True)
    return _apply_layer(h, lp, btype, cfg, positions, mode, **kw)


def _write_back(dst, src) -> None:
    """Copy a decode step's new block state ``src`` into ``dst``, the
    stacked cache's views for that layer, leaf by leaf (a leaf the block
    updated in place is ``dst`` itself and is skipped)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _write_back(v, src[k])
    elif dst is not src:
        dst.copy_(src)


def _unstack(tree, count: int) -> list:
    """A dict tree of stacked (count, ...) leaves -> ``count`` trees of
    their slices, one ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where indexing each layer would add a zero-filled
    stacked gradient per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][j] for k in tree} for j in range(count)]
    return list(tree.unbind(0))


def _backbone(params, h, cfg: ArchConfig, positions, mode: str,
              caches=None, pos=None, max_len: int = 0, enc_h=None,
              segments_key: str = "segments", segments=None,
              causal: bool = True, mesh=None, tp=None, kv_splits=None,
              on_state=None):
    """Every layer of ``params[segments_key]`` (laid out as ``segments``,
    default ``segments_for(cfg)``) in order.  Returns (h, aux, caches):
    ``aux`` the layers' summed router losses (float32) in train mode,
    ``None`` in prefill and decode, which build no loss; prefill builds
    stacked caches, decode updates ``caches`` in place and returns it,
    train has none.  In train mode with ``cfg.remat``, each layer runs
    under ``torch.utils.checkpoint`` (its activations recomputed in the
    backward; the values do not change).  ``kv_splits`` holds, per
    segment and slot, the ``kv_split`` of :func:`_apply_layer`.  In a
    train step's ``tp`` each layer's slices of the stacked leaves are
    gathered over the data axes just before it runs (:func:`_run_layer`),
    never the stack, and dropped after it.  ``on_state(layer, kind, h)``,
    when given, receives each layer's input (``"input"``), its blocks'
    outputs (:func:`_apply_layer`) and the last layer's output
    (``"output"``), ``layer`` counting over the segments."""
    train = mode == "train"
    aux_total = (torch.zeros((), dtype=torch.float32, device=h.device)
                 if train else None)
    new_caches = []
    layer = 0
    for i, (pattern, count) in enumerate(segments or segments_for(cfg)):
        seg_p = [_unstack(p, count) for p in params[segments_key][i]]
        seg_c = caches[i] if caches is not None else None
        per_layer = []
        for j in range(count):
            ncs = []
            for si, btype in enumerate(pattern):
                lp = seg_p[si][j]
                c_in = (tree_map(lambda x: x[j], seg_c[si])
                        if seg_c is not None else None)
                kw = dict(cache=c_in, pos=pos, max_len=max_len, enc_h=enc_h,
                          causal=causal, mesh=mesh, tp=tp,
                          kv_split=kv_splits[i][si] if kv_splits else None,
                          data_key=(segments_key, i, si))
                if on_state is not None:
                    on_state(layer, "input", h)
                    kw["on_state"] = functools.partial(on_state, layer)
                layer += 1
                if train and cfg.remat and h.requires_grad:
                    h, a, nc = torch.utils.checkpoint.checkpoint(
                        _run_layer, h, lp, btype, cfg, positions, mode,
                        use_reentrant=False, **kw)
                else:
                    h, a, nc = _run_layer(h, lp, btype, cfg, positions,
                                          mode, **kw)
                if train:
                    aux_total = aux_total + a
                if mode == "decode":
                    _write_back(c_in, nc)
                ncs.append(nc)
            per_layer.append(tuple(ncs))
        if mode == "decode":
            new_caches.append(seg_c)
        elif mode == "prefill":
            new_caches.append(_stack_trees(per_layer))
    if on_state is not None:
        on_state(layer - 1, "output", h)
    return h, aux_total, tuple(new_caches)


# ---------------------------------------------------------------------------
# Embedding / head.
# ---------------------------------------------------------------------------


def _param(params, key: str, tp):
    """``params[key]`` (a top-level leaf or subtree) as a call uses it:
    in a train step whole over the data axes, gathered here
    (``TP.over_data``)."""
    return params[key] if tp is None else tp.over_data(params[key], key)


def _embed(params, tokens, cfg: ArchConfig, tp=None):
    """Token embeddings; under ``tp`` with the table's rows (the vocab)
    split over 'model' each rank looks up the tokens it holds, zeros
    elsewhere, and the ranks' rows are summed (exact: one is nonzero)."""
    table = _param(params, "embed", tp)
    if tp is not None and tp.kind("embed") == "vocab":
        n = table.shape[0]
        idx = tokens - tp.rank * n
        held = (idx >= 0) & (idx < n)
        h = table[torch.where(held, idx, torch.zeros_like(idx))]
        h = tp.reduce(torch.where(held[..., None], h, torch.zeros_like(h)))
    else:
        h = table[tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def _vocab_split(cfg: ArchConfig, tp) -> bool:
    """Whether the head's vocab columns are split over 'model' (a tied
    table of kind ``"vocab"`` or an unembed of kind ``"column"``)."""
    if tp is None:
        return False
    if cfg.tie_embeddings:
        return tp.kind("embed") == "vocab"
    return tp.kind("unembed") == "column"


def _lm_head(h, params, cfg: ArchConfig, tp=None, gather: bool = True):
    """Logits of (B, S, d) ``h``; under ``tp`` (``h`` whole on this rank,
    from ``TP.enter``) the head's vocab columns are computed here and
    gathered whole (``gather=False``: this rank's columns only); a head
    split over d_model is row-parallel, one split over neither runs whole
    on every rank."""
    split = _vocab_split(cfg, tp)
    if cfg.tie_embeddings:
        if tp is not None and not split:
            h = tp.replicated(h)
        logits = torch.einsum("bsd,vd->bsv", h, _param(params, "embed", tp))
    else:
        kind = tp.kind("unembed") if tp is not None else None
        w = _param(params, "unembed", tp)
        if kind == "row":
            n = h.shape[-1] // tp.n
            logits = radix_lib.maybe_radix_matmul(
                h[..., tp.rank * n:(tp.rank + 1) * n], w,
                cfg=cfg, tp=tp.with_seq(False))
        else:
            if kind not in (None, "column"):
                h = tp.replicated(h)
            logits = radix_lib.maybe_radix_matmul(h, w, cfg=cfg)
    if split and gather:
        logits = tp.gather(logits, -1)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _positions(cfg: ArchConfig, b: int, s_len: int, device=None):
    """(B, S) positions, or (3, B, S) M-RoPE streams (text: t == h == w)."""
    pos = torch.arange(s_len, device=device).expand(b, s_len)
    if cfg.mrope_sections is not None:
        return pos.expand(3, b, s_len)
    return pos


def _input_h(params, batch, cfg: ArchConfig, tp=None):
    """(h, labels) from a batch dict: ``tokens`` (B, S + 1), or for an
    embedding-input arch ``embeds`` (B, S, d) (and ``labels``, which
    serving does not need); learned positions added."""
    if cfg.embedding_inputs:
        h, labels = batch["embeds"].to(_dt(cfg)), batch.get("labels")
    else:
        tokens = batch["tokens"]
        h, labels = _embed(params, tokens[:, :-1], cfg, tp), tokens[:, 1:]
    if cfg.pos_embed == "learned":
        h = h + _param(params, "pos_embed", tp)[:h.shape[1]][None].to(h.dtype)
    return h, labels


def _seq_split(cfg: ArchConfig, tp, s_len: int) -> bool:
    """The reference's ``_resid_spec``: the residual stream is split over
    the sequence on 'model' when ``cfg.seq_shard`` and the length
    divides the axis."""
    return (tp is not None and cfg.seq_shard and tp.n > 1
            and s_len % tp.n == 0 and s_len >= tp.n)


def _seq_piece(h, tp):
    """This rank's tokens of the whole (B, S, d) ``h`` under
    ``tp.seq``."""
    return tp.piece(h, 1) if tp is not None and tp.seq else h


def _encode_whisper(params, enc_embeds, cfg: ArchConfig, mesh=None, tp=None):
    """The encoder: (B, encoder_ctx, d) frame embeddings plus learned
    positions through the non-causal ``enc_segments`` stack, then its
    final norm (under ``tp``: this rank's frames under its ``seq``)."""
    dt = _dt(cfg)
    h = enc_embeds.to(dt) + _param(params, "enc_pos_embed", tp)[None].to(dt)
    pos = _positions(cfg, h.shape[0], h.shape[1], device=h.device)
    if tp is not None:
        tp = tp.with_seq(_seq_split(cfg, tp, h.shape[1]))
        h = _seq_piece(h, tp)
    h, _, _ = _backbone(params, h, cfg, pos, "train",
                        segments_key="enc_segments",
                        segments=((("attn",), cfg.encoder_layers),),
                        causal=False, mesh=mesh, tp=tp)
    h = _norm(h, _param(params, "enc_final_norm", tp), cfg, tp)
    if tp is not None and tp.seq:
        h = tp.gather(h, 1)
    return h


# ---------------------------------------------------------------------------
# Training: forward, loss, train step.
# ---------------------------------------------------------------------------


def forward_train(params, batch, cfg: ArchConfig, mesh=None, tp=None):
    """Teacher-forced forward over a batch dict (as :func:`prefill` takes
    it, ``labels`` too for an embedding-input arch).  Returns (logits
    (B, S, V), labels (B, S), aux): ``aux`` the MoE layers' summed router
    loss (0 without MoE).  With a mesh: this rank's batch shard and its
    pieces of the parameters with their layout ``tp`` (what
    :func:`make_train_step` passes; else they are cut here, keeping their
    pieces over the data axes); the logits are gathered whole."""
    h, labels, aux, params, tp = _train_h(params, batch, cfg, mesh, tp)
    return _lm_head(h, params, cfg, tp), labels, aux


def _train_h(params, batch, cfg: ArchConfig, mesh, tp):
    """:func:`forward_train` up to the head: (h (B, S, d) after the final
    norm, whole on this rank under ``tp``, labels, aux, the parameters'
    pieces, ``tp``)."""
    if mesh is not None and tp is None:
        params, tp = tp_lib.shard_params(params, cfg, mesh, keep_data=True)
    h, labels = _input_h(params, batch, cfg, tp)
    enc_h = None
    if cfg.encoder_layers:
        enc_h = _encode_whisper(params, batch["enc_embeds"], cfg, mesh, tp)
    positions = _positions(cfg, h.shape[0], h.shape[1], device=h.device)
    if tp is not None:
        tp = tp.with_seq(_seq_split(cfg, tp, h.shape[1]))
        h = _seq_piece(h, tp)
    h, aux, _ = _backbone(params, h, cfg, positions, "train", enc_h=enc_h,
                          mesh=mesh, tp=tp)
    h = _norm(h, _param(params, "final_norm", tp), cfg, tp)
    if tp is not None:
        h = tp.enter(h)
    return h, labels, aux, params, tp


def loss_fn(params, batch, cfg: ArchConfig, mesh=None,
            aux_weight: float = 0.01, tp=None):
    """(loss, {"ce", "aux", "acc"}): token cross-entropy in float32 plus
    ``aux_weight`` times the router loss.  The gold logit is gathered
    where the reference contracts a one-hot (the same value for finite
    logits, without a (B, S, V) one-hot: 4.19 GB at Gemma-2B's vocab and
    8 x 512 tokens).  With a mesh whose head splits the vocab over
    'model', each rank computes on its own vocab columns and no rank
    joins them (:func:`_vocab_parallel_ce`)."""
    h, labels, aux, params, tp = _train_h(params, batch, cfg, mesh, tp)
    if _vocab_split(cfg, tp) and tp.n > 1:
        ce, acc = _vocab_parallel_ce(
            _lm_head(h, params, cfg, tp, gather=False), labels, tp)
    else:
        lf = _lm_head(h, params, cfg, tp).to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        ce = (lse - gold).mean()
        acc = (lf.argmax(-1) == labels).to(torch.float32).mean()
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "acc": acc}


def _vocab_parallel_ce(logits, labels, tp):
    """(ce, acc) of this rank's vocab columns ``logits`` (B, S, V / model;
    columns ``rank * V / model`` on, softcapped) of a head split over
    'model', no rank holding every column: logsumexp as the max over
    'model' and the sum over 'model' of each rank's ``exp`` sums; the
    gold logit from the rank that holds it, summed over 'model' (exact:
    the others add 0); the argmax as the (value, global index) max over
    'model', ties to the lowest index as ``argmax``.  The sums over
    'model' pass the gradient through unchanged (``TP.reduce``), so each
    rank's columns get their own."""
    lf = logits.to(torch.float32)
    n_v = lf.shape[-1]
    lo = tp.rank * n_v
    top = tp.max(lf.detach().amax(-1))
    z = tp.reduce(torch.exp(lf - top[..., None]).sum(-1))
    lse = top + torch.log(z)
    idx = labels.long() - lo
    held = (idx >= 0) & (idx < n_v)
    g = torch.gather(lf, -1, idx.clamp(0, n_v - 1)[..., None])[..., 0]
    gold = tp.reduce(torch.where(held, g, torch.zeros_like(g)))
    ce = (lse - gold).mean()
    arg = lf.detach().argmax(-1)
    val = torch.gather(lf.detach(), -1, arg[..., None])[..., 0]
    cand = torch.where(val == tp.max(val), arg + lo,
                       torch.full_like(arg, n_v * tp.n))
    pred = -tp.max(-cand)
    acc = (pred == labels).to(torch.float32).mean()
    return ce, acc


def _data_shard(batch: dict, cfg: ArchConfig, mesh) -> dict:
    """This rank's rows of a batch dict: global tensors are cut, DTensors
    (``data.pipeline.ShardedLoader``'s) are gathered over every axis but
    the data axes (an embedding input's sequence may be split over
    'model')."""
    from torch.distributed.tensor import DTensor

    specs = SH.batch_specs(batch, cfg, mesh, seq_shard=False)
    return {k: (v.redistribute(mesh, SH.placements(specs[k], mesh))
                .to_local() if isinstance(v, DTensor)
                else SH.local_slice(v, specs[k], mesh))
            for k, v in batch.items()}


def _over_data(t, n: int):
    """``t`` divided by ``n`` in its dtype, on its device (the data
    ranks' summed gradients -> their mean)."""
    return t / torch.tensor(float(n), dtype=t.dtype, device=t.device)


def _mean_over_data(tree, mesh):
    """Each leaf (the loss and metrics) summed over the data axes in rank
    order and divided by their size (``collectives.sum_fixed``: the same
    bits on every rank); the identity on one data rank."""
    dp = SH.dp_axes(mesh)
    n = C.group_size(mesh, dp)
    if n == 1:
        return tree
    return tree_map(lambda t: _over_data(C.sum_fixed(t, mesh, dp), n), tree)


def _piece_spec(local, whole) -> tuple:
    """The spec of this rank's piece ``local`` of the leaf ``whole``: a
    DTensor's entries on the dims where the piece is shorter, 'model'
    there for a whole tensor (cut over 'model' only)."""
    from torch.distributed.tensor import DTensor

    if isinstance(whole, DTensor):
        return tuple(e if a < b else None for e, a, b in zip(
            SH.spec_of(whole), local.shape, whole.shape))
    return tuple("model" if a < b else None
                 for a, b in zip(local.shape, whole.shape))


def _live(spec, mesh) -> tuple:
    """``spec`` without the mesh axes of one rank."""
    sizes = SH.axis_sizes(mesh)
    out = []
    for e in spec:
        axes = tuple(a for a in SH.entry_axes(e) if sizes[a] > 1)
        out.append(axes or None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _split_dim(spec, axes) -> int:
    """The dim of ``spec`` split over ``axes`` (-1: none)."""
    return next((d for d, e in enumerate(spec)
                 if set(SH.entry_axes(e)) & set(axes)), -1)


def _piece_of(t, lspec, mesh):
    """A leaf (DTensor or whole tensor) as the step computes on it: its
    piece as ``lspec`` lays it out.  A DTensor stored so gives its own
    piece; one that splits a dim ``lspec`` keeps whole (an Adafactor
    statistic ``opt_state_specs`` moved onto another dim) is gathered
    over those axes by ``collectives.gather_from`` (through the host on
    gloo, as DTensor's own collectives are not), and one that ``lspec``
    splits further is cut."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return SH.local_slice(t, lspec, mesh)
    have, want = _live(SH.spec_of(t), mesh), _live(lspec, mesh)
    piece = t.to_local()
    if have == want:
        return piece
    cut = []
    for d in range(piece.ndim):
        h = have[d] if d < len(have) else None
        w = want[d] if d < len(want) else None
        if h != w and h is not None:
            if w is not None:
                raise ValueError(f"a piece laid out as {have} cannot be "
                                 f"taken as {want}")
            piece = C.gather_from(piece, d, mesh, h)
        cut.append(w if h != w else None)
    return SH.local_slice(piece, tuple(cut), mesh)


def _put_back(new, old, lspec, mesh):
    """The step's new ``lspec`` piece of a leaf stored as ``old``: this
    rank's piece in ``old``'s placements (a DTensor: cut where ``old``
    splits a dim ``lspec`` does not), or the whole tensor gathered over
    'model' (a whole tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(old, DTensor):
        for d, e in enumerate(lspec):
            if e is not None:
                new = C.gather_from(new, d, mesh, ("model",))
        return new
    spec = SH.spec_of(old)
    rest = tuple(None if l is not None else e for e, l in zip(spec, lspec))
    return DTensor.from_local(SH.local_slice(new, rest, mesh).contiguous(),
                              mesh, old.placements, run_check=False)


def make_train_step(cfg: ArchConfig, opt: optim_lib.Optimizer,
                    clip_norm: float = 1.0, *, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` with state
    ``{"params", "opt", "step"}``: gradients by autograd, clipped to
    ``clip_norm`` global norm, one ``opt`` update.  ``cfg.grad_accum``
    = A > 1 splits the batch into A microbatches run one after another;
    their gradients are summed in float32 and divided by A.

    With a ``mesh`` the state's leaves may be DTensors (each rank storing
    its piece, ``parallel/sharding.place``) or whole tensors, and the
    batch global tensors or ``ShardedLoader`` DTensors.  The step is the
    reference's ZeRO-3 layout written out: it keeps each DTensor leaf's
    stored piece over the data axes and 'model' (``tp.shard_params(...,
    keep_data=True)``; a whole tensor is cut over 'model' only) and
    gathers nothing at its start.  On this data rank's batch shard the
    forward and backward run over 'model' (``parallel/tp.py``; a MoE
    layer's mesh dispatch on this rank's experts), each layer's pieces
    gathered over the data axes just before the layer runs and dropped
    after it (regathered in the backward under ``cfg.remat``), each
    top-level leaf where it is used; a piece's gradient comes back
    reduce-scattered over the data axes, a leaf stored whole over them
    gets its gradient summed over them (``collectives.fsdp_gather`` /
    ``fsdp_copy``, rank order), and each is divided by the data size.
    With ``cfg.grad_accum`` > 1 the pieces' gradients are summed in
    float32 over the microbatches.  Only the loss, the metrics and the
    optimizer's partial sums are summed over the data axes
    (``collectives.sum_fixed``).  The optimizer updates the pieces in
    the state's placements (``sharding.opt_state_specs``; ``optim.Shards``
    per group of ranks: the global norm, Adafactor's factored statistics
    and RMS clip summed over the groups that split them), except that an
    Adafactor statistic the specs move onto another dim (ZeRO-2 of the
    statistics: O(rows + columns)) is gathered for the update and cut
    back; each new leaf keeps its old placement, with no gather.

    Float order: a piece's gradient is the data ranks' partial gradients
    added in rank order in float32, where one card's backward takes one
    GEMM over the whole batch; the loss and metrics, the global norm's
    sums and Adafactor's statistics are sums of per-rank partial sums;
    the vocab-parallel loss adds the ranks' ``exp`` sums.  So a step over
    the mesh agrees with one card's to float rounding, not bit for
    bit."""

    def grads_of(params, batch, tp=None):
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(ps, batch, cfg, mesh, tp=tp)
        grads = torch.autograd.grad(loss, tree_lib.leaves(ps),
                                    allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_lib.unflatten(ps, grads)

    def accumulate(params, batch, tp=None):
        a = cfg.grad_accum
        if a == 1:
            return grads_of(params, batch, tp)
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        lsum, ms = 0.0, []
        for i in range(a):
            mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            l, m, g = grads_of(params, mb, tp)
            grads = tree_map(torch.add, grads, g)
            lsum = lsum + l
            ms.append(m)
        div = torch.tensor(float(a), dtype=torch.float32, device=lsum.device)
        grads = tree_map(lambda g: g / div, grads)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return lsum / div, metrics, grads

    def sharded_step(state, batch):
        params, tp = tp_lib.shard_params(state["params"], cfg, mesh,
                                         keep_data=True)
        lspecs = tree_map(_piece_spec, params, state["params"])
        ospecs = SH.opt_state_specs(lspecs, state["opt"], mesh,
                                    replace_dp=False)
        opt_l = tree_map(lambda t, sp: _piece_of(t, sp, mesh), state["opt"],
                         ospecs)
        loss, metrics, grads = accumulate(params,
                                          _data_shard(batch, cfg, mesh), tp)
        dp = SH.dp_axes(mesh)
        n_dp = C.group_size(mesh, dp)
        if n_dp > 1:
            grads = tree_map(lambda g: _over_data(g, n_dp), grads)
        loss, metrics = _mean_over_data((loss, metrics), mesh)
        pg = C.group(mesh, ("model",))
        shards = [optim_lib.Shards(
            dims=tree_map(lambda _, sp: _split_dim(sp, ("model",)), params,
                          lspecs),
            n=tp.n, sum=lambda t: C.all_reduce_(t, pg))]
        if n_dp > 1:
            shards.insert(0, optim_lib.Shards(
                dims=tree_map(lambda _, sp: _split_dim(sp, dp), params,
                              lspecs),
                n=n_dp, sum=lambda t: C.sum_fixed(t, mesh, dp)))
        if clip_norm:
            grads, gnorm = optim_lib.clip_by_global_norm(grads, clip_norm,
                                                         shards)
        else:
            gnorm = optim_lib.global_norm(grads, shards)
        updates, new_opt = opt.update(grads, opt_l, params, shards=shards)
        del grads                   # before the new parameters exist
        new_p = optim_lib.apply_updates(params, updates)
        step_t = state["step"]
        new = {"params": tree_map(lambda t, o, sp: _put_back(t, o, sp, mesh),
                                  new_p, state["params"], lspecs),
               "opt": tree_map(lambda t, o, sp: _put_back(t, o, sp, mesh),
                               new_opt, state["opt"], ospecs),
               "step": tree_map(SH.shard_like, SH.gather(step_t) + 1,
                                step_t)}
        return new, dict(metrics, loss=loss, grad_norm=gnorm)

    def step(state, batch):
        if mesh is not None:
            return sharded_step(state, batch)
        loss, metrics, grads = accumulate(state["params"], batch)
        params = state["params"]
        if clip_norm:
            grads, gnorm = optim_lib.clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = optim_lib.global_norm(grads)
        updates, new_opt = opt.update(grads, state["opt"], params)
        del grads                   # before the new parameters exist
        new = {"params": optim_lib.apply_updates(params, updates),
               "opt": new_opt, "step": state["step"] + 1}
        return new, dict(metrics, loss=loss, grad_norm=gnorm)

    return step


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode.
# ---------------------------------------------------------------------------


def _cache_entry(cfg: ArchConfig, btype: str, batch: int, max_len: int,
                 device, has_x: bool = False) -> dict:
    dt = _dt(cfg)
    if btype in ("attn", "local_attn"):
        length = (min(cfg.window, max_len) if btype == "local_attn"
                  else max_len)
        e = radix_lib.init_cache_entry(cfg, batch, length, dt, device=device)
        if has_x:
            kv = (batch, cfg.encoder_ctx, cfg.n_kv_heads, cfg.hd)
            e = {"self": e,
                 "cross": {"k": torch.zeros(kv, dtype=dt, device=device),
                           "v": torch.zeros(kv, dtype=dt, device=device)}}
        return e
    if btype == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                    dtype=dt, device=device),
                "h": torch.zeros((batch, w), device=device)}
    if btype == "rwkv6":
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"mix": {"last_x": torch.zeros((batch, d), dtype=dt,
                                              device=device),
                        "S": torch.zeros((batch, d // hd, hd, hd),
                                         device=device)},
                "cmix": {"last_x": torch.zeros((batch, d), dtype=dt,
                                               device=device)}}
    raise ValueError(btype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """Zeros caches, one stacked entry per segment slot, on ``device``
    (``None`` means CUDA, and raises when there is none)."""
    check_supported(cfg)
    device = _resolve_device(device)
    caches = []
    for pattern, count in segments_for(cfg):
        slots = []
        for btype in pattern:
            e = _cache_entry(cfg, btype, batch, max_len, device,
                             has_x=bool(cfg.encoder_layers))
            slots.append(tree_map(lambda v: v.expand(
                (count,) + tuple(v.shape)).clone(), e))
        caches.append(tuple(slots))
    return tuple(caches)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, mode):
    """:func:`init_cache`'s trees as fake tensors of ``mode`` on "cpu"
    (the reference's ``abstract_cache``)."""
    with mode:
        return init_cache(cfg, batch, max_len, device="cpu")


class Sharded(NamedTuple):
    """A parameter tree cut once to this rank's pieces over 'model'
    (:func:`shard`), with its layout: :func:`prefill` and
    :func:`decode_step` take it in place of the tree and cut nothing per
    call."""
    params: Any
    tp: Any


def shard(params, cfg: ArchConfig, mesh) -> Sharded:
    """This rank's pieces of ``params`` (DTensors or whole tensors) over
    'model', each in its own storage (``tp.shard_params(...,
    contiguous=True)``): what a deployment serves from, the K-major
    levels of a row split included."""
    local, tp = tp_lib.shard_params(params, cfg, mesh, contiguous=True)
    return Sharded(local, tp)


def _sharded(params, cfg: ArchConfig, mesh):
    if isinstance(params, Sharded):
        return params.params, params.tp
    return tp_lib.shard_params(params, cfg, mesh)


def _cache_layout(cfg: ArchConfig, batch: int, max_len: int, mesh):
    """(spec tree of the global caches, per segment and slot the
    ``kv_split`` of each attention cache): ``sharding.cache_specs`` of
    :func:`init_cache`'s shapes (meta tensors, no memory)."""
    specs = SH.cache_specs(init_cache(cfg, batch, max_len, device="meta"),
                           cfg, mesh)
    return specs, _kv_splits(cfg, specs)


def _kv_splits(cfg: ArchConfig, specs):
    """Per segment and slot, whether each attention cache of the spec
    tree ``specs`` splits its slots over 'model'."""

    def split(spec):
        return len(spec) > 2 and "model" in SH.entry_axes(spec[2])

    kv = []
    for (pattern, _), seg in zip(segments_for(cfg), specs):
        row = []
        for btype, slot in zip(pattern, seg):
            if btype in ("attn", "local_attn"):
                if "self" in slot:
                    row.append({"self": split(slot["self"]["k"]),
                                "cross": split(slot["cross"]["k"])})
                else:
                    row.append({"self": split(slot["k"])})
            else:
                row.append({})
        kv.append(tuple(row))
    return tuple(kv)


def _place_piece(piece, spec, whole_shape, mesh):
    """A DTensor of ``spec`` from this rank's ``piece`` (checked against
    the piece ``spec`` gives of the whole shape)."""
    from torch.distributed.tensor import DTensor

    want = tuple(SH.local_slice(torch.empty(whole_shape, device="meta"),
                                spec, mesh).shape)
    if tuple(piece.shape) != want:
        raise ValueError(f"cache piece {tuple(piece.shape)} is not the "
                         f"{want} that {spec} gives of {whole_shape}")
    return DTensor.from_local(piece.contiguous(), mesh,
                              SH.placements(spec, mesh), run_check=False)


def prefill(params, batch, cfg: ArchConfig, mesh=None, max_len: int = 0,
            *, true_len: Optional[int] = None, on_state=None):
    """Process the prompt; returns (last-token logits (B, V), caches).

    ``batch["tokens"]`` is (B, S + 1) (the last column is the label of the
    last position, as the reference's ``_input_h`` consumes it); an
    embedding-input arch takes ``batch["embeds"]`` (B, S, d) instead, and
    an encoder-decoder also ``batch["enc_embeds"]`` (B, encoder_ctx, d).
    ``max_len`` sizes the decode cache (default: prompt length).
    ``true_len`` gathers the last-token state at ``true_len - 1`` of a
    right-padded prompt (bucketed prefill: exact for pure full-attention
    stacks, since the causal mask hides the pads; not for recurrent or
    windowed blocks, whose state would absorb them).  ``on_state(layer,
    kind, h)``, when given, is handed each layer's states as they are
    computed (``LMExecutable.prefill`` documents the kinds).

    With a ``mesh``: parameters (DTensors or whole tensors, each rank
    using its pieces over 'model'; or a :class:`Sharded`), the global
    batch, of which each data rank runs its rows; the logits are gathered
    whole on every rank, and the caches are DTensors placed by
    ``parallel.sharding.cache_specs`` (batch over the data axes, the KV
    sequence over 'model'), each rank having computed only its piece."""
    if mesh is None:
        return _prefill(params, batch, cfg, None, max_len, true_len,
                        on_state=on_state)
    local, tp = _sharded(params, cfg, mesh)
    first = batch["embeds"] if cfg.embedding_inputs else batch["tokens"]
    b_glob = first.shape[0]
    s_len = first.shape[1] - (0 if cfg.embedding_inputs else 1)
    specs, kv_splits = _cache_layout(cfg, b_glob, max_len or s_len, mesh)
    logits, caches = _prefill(local, _data_shard(batch, cfg, mesh), cfg,
                              mesh, max_len, true_len, tp, kv_splits,
                              on_state)
    whole = init_cache(cfg, b_glob, max_len or s_len, device="meta")
    placed = tree_map(lambda c, w, spec: _place_piece(c, spec, tuple(w.shape),
                                                      mesh),
                      caches, whole, specs)
    return _gather_rows(logits, mesh), placed


def _prefill(params, batch, cfg: ArchConfig, mesh, max_len: int, true_len,
             tp=None, kv_splits=None, on_state=None):
    h, _ = _input_h(params, batch, cfg, tp)
    b, s_len = h.shape[0], h.shape[1]
    max_len = max_len or s_len
    enc_h = None
    if cfg.encoder_layers:
        enc_h = _encode_whisper(params, batch["enc_embeds"], cfg, mesh, tp)
    positions = _positions(cfg, b, s_len, device=h.device)
    if tp is not None:
        tp = tp.with_seq(_seq_split(cfg, tp, s_len))
        h = _seq_piece(h, tp)
    h, _, caches = _backbone(params, h, cfg, positions, "prefill",
                             max_len=max_len, enc_h=enc_h, mesh=mesh, tp=tp,
                             kv_splits=kv_splits, on_state=on_state)
    idx = s_len if true_len is None else int(true_len)
    if tp is not None and tp.seq:       # the rank holding token idx - 1
        n = s_len // tp.n
        owner, at = divmod(idx - 1, n)
        row = h[:, at:at + 1]
        row = tp.reduce(row if tp.rank == owner else torch.zeros_like(row))
    else:
        row = h[:, idx - 1:idx]
    row = blocks.norm(row, params["final_norm"], cfg.norm)
    if tp is not None:
        tp = tp.with_seq(False)
        row = tp.enter(row)
    logits = _lm_head(row, params, cfg, tp)[:, 0]
    return logits, caches


def _gather_rows(t, mesh):
    """Every data rank's rows of ``t`` joined in mesh order."""
    return C.gather_from(t, 0, mesh, SH.dp_axes(mesh))


def decode_step(params, caches, tokens, pos, cfg: ArchConfig, mesh=None):
    """One decode step.  ``tokens`` (B, 1) ints (embeds (B, 1, d) for an
    embedding-input arch); ``pos`` the position being written (an int).
    Returns (logits (B, V), caches) with ``caches`` (attention caches and
    recurrent states) updated in place.

    With a ``mesh``: ``caches`` are :func:`prefill`'s DTensors, of which
    each rank reads and writes its own piece: its data rank's rows, and
    over 'model' its slots of each KV cache (the rank holding slot
    ``pos`` writes it; the ranks' attention states are merged) and its
    channels or heads of each recurrent state.  The parameters are used
    as :func:`prefill` uses them; the logits are gathered whole."""
    if mesh is None:
        return _decode(params, caches, tokens, pos, cfg, None), caches
    local, tp = _sharded(params, cfg, mesh)
    specs = tree_map(SH.spec_of, caches)
    pieces = tree_map(lambda c: c.to_local(), caches)
    kv_splits = _kv_splits(cfg, specs)
    logits = _decode(local, pieces,
                     _data_shard({"t": tokens}, cfg, mesh)["t"], pos, cfg,
                     mesh, tp, kv_splits)
    return _gather_rows(logits, mesh), caches


def _decode(params, caches, tokens, pos, cfg: ArchConfig, mesh, tp=None,
            kv_splits=None):
    pos = int(pos)
    if cfg.embedding_inputs:
        h = tokens.to(_dt(cfg))
    else:
        h = _embed(params, tokens, cfg, tp)
    if cfg.pos_embed == "learned":
        h = h + params["pos_embed"][pos:pos + 1][None].to(h.dtype)
    h, _, _ = _backbone(params, h, cfg, None, "decode", caches=caches,
                        pos=pos, mesh=mesh, tp=tp, kv_splits=kv_splits)
    h = blocks.norm(h, params["final_norm"], cfg.norm)
    if tp is not None:
        h = tp.enter(h)
    return _lm_head(h, params, cfg, tp)[:, 0]
