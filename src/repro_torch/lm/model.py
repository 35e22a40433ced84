"""Model construction: init / prefill / decode from an ArchConfig (port of
``repro/lm/model.py``, the serving subset).

Public surface (functions of param and cache trees):

    init_params(generator, cfg, device=)   real parameters, seeded
    radixify_params(params, cfg)           paper-technique serving weights
    kmajor_params(params)                  their levels in the kernel's layout
    init_cache(cfg, batch, max_len, device=)
    prefill(params, batch, cfg, max_len=, true_len=) -> last_logits, caches
    decode_step(params, caches, tokens, pos, cfg)    -> logits, caches

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
Training waits (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.api import _resolve_device
from repro_torch.lm import blocks, moe as moe_lib, radix as radix_lib
from repro_torch.lm.config import ArchConfig, segments_for
from repro_torch.lm.radix import torch_dtype

__all__ = ["init_params", "radixify_params", "kmajor_params", "init_cache",
           "prefill", "decode_step", "tree_map"]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
    """Raise ``ValueError`` for what no reference arch has (an unknown
    block type, activation or position embedding) and
    ``NotImplementedError`` for what this port does not run yet: MoE
    dispatch over a device mesh (``moe.pick_impl``)."""
    bad = sorted(set(cfg.layer_types) - set(BLOCK_TYPES))
    if bad:
        raise ValueError(f"unknown block types {bad} (known: "
                         f"{BLOCK_TYPES})")
    if cfg.act not in ACTS:
        raise ValueError(f"unknown act {cfg.act!r} (known: {ACTS})")
    if cfg.pos_embed not in POS_EMBEDS:
        raise ValueError(f"unknown pos_embed {cfg.pos_embed!r} (known: "
                         f"{POS_EMBEDS})")
    if cfg.moe is not None:
        moe_lib.pick_impl(cfg)


# ---------------------------------------------------------------------------
# Initialization.
# ---------------------------------------------------------------------------


def _nrm(gen: torch.Generator, shape, scale: float, dtype, device):
    """N(0, scale^2) in ``dtype``, drawn in float32 one trailing matrix at
    a time: a stacked leaf's float32 transient is one matrix, not the
    leaf (Grok-1's stacked experts are 25.8 GB in float32 at 4 layers)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    mats = out.view((-1,) + tuple(shape[-2:])) if len(shape) > 2 else [out]
    for m in mats:
        m.copy_(torch.randn(m.shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(scale))
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


def _apply_layer(h, lp, btype: str, cfg: ArchConfig, positions, mode: str,
                 cache=None, pos=None, max_len: int = 0, enc_h=None):
    """One block: temporal mix (+ cross-attention over the encoder's
    output ``enc_h`` in a layer that has ``xattn``) + channel mix, each
    with its pre-norm and residual.  ``mode="prefill"`` returns the
    layer's new cache; ``"decode"`` consumes ``cache`` and returns the
    block's new state (an attention cache is updated in place and
    returned as is); ``"encode"`` is the encoder's non-causal attention
    block, with no cache.

    Cache structure by block type:
      attn / local_attn : {"k", "v"(, "k_scale", "v_scale")} of length
                          max_len (a ring buffer of min(window, max_len)
                          slots for local_attn)
      rglru             : {"conv": (B, K-1, W), "h": (B, W)}
      rwkv6             : {"mix": {"last_x", "S"}, "cmix": {"last_x"}}
      whisper decoder   : {"self": <attn>, "cross": {"k", "v"}}, the
                          cross K/V float (B, encoder_ctx, Hkv, hd)
    Returns (h, cache)."""
    if mode not in ("prefill", "decode", "encode"):
        raise ValueError(f"mode must be 'prefill', 'decode' or 'encode', "
                         f"got {mode!r}")
    prefill = mode == "prefill"
    has_x = "xattn" in lp
    hn = blocks.norm(h, lp["ln1"], cfg.norm)
    new_mix = None
    if btype in ("attn", "local_attn"):
        window = cfg.window if btype == "local_attn" else 0
        if mode == "encode":
            mix = blocks.attention(hn, lp["mix"], cfg, positions,
                                   causal=False)
        elif prefill:
            mix, (k, v) = blocks.attention(hn, lp["mix"], cfg, positions,
                                           window=window, return_kv=True)
            length = min(window, max_len) if window else max_len
            if k.shape[1] > length:     # windowed: keep the last positions
                k, v = k[:, -length:], v[:, -length:]
            pad = length - k.shape[1]
            if pad:
                z = torch.zeros((k.shape[0], pad) + tuple(k.shape[2:]),
                                dtype=k.dtype, device=k.device)
                k = torch.cat([k, z], 1)
                v = torch.cat([v, z], 1)
            new_mix = radix_lib.encode_cache_bulk(
                k.to(_dt(cfg)), v.to(_dt(cfg)), cfg, _dt(cfg))
        else:
            mix, new_mix = blocks.decode_attention(
                hn, lp["mix"], cfg, cache["self"] if has_x else cache, pos,
                window=window)
    elif btype == "rglru":
        mix, new_mix = blocks.rglru_block(
            hn, lp["mix"], cfg, state=None if prefill else cache,
            return_state=True)
    elif btype == "rwkv6":
        mix, new_mix = blocks.rwkv6_block(
            hn, lp["mix"], cfg, state=None if prefill else cache["mix"],
            return_state=True)
    else:
        raise ValueError(btype)
    h = h + mix

    if has_x:           # whisper decoder: cross-attention before the FFN
        hx = blocks.norm(h, lp["lnx"], cfg.norm)
        if prefill:
            k_enc = torch.einsum("bsd,dhk->bshk", enc_h, lp["xattn"]["wk"])
            v_enc = torch.einsum("bsd,dhk->bshk", enc_h, lp["xattn"]["wv"])
            xmix = blocks.attention(hx, lp["xattn"], cfg, positions,
                                    cross_kv=(k_enc, v_enc))
            cross = {"k": k_enc.to(_dt(cfg)), "v": v_enc.to(_dt(cfg))}
        else:
            cross = cache["cross"]
            xmix, _ = blocks.decode_attention(hx, lp["xattn"], cfg, cross,
                                              pos, cross=True)
        h = h + xmix
        new_mix = {"self": new_mix, "cross": cross}

    hn = blocks.norm(h, lp["ln2"], cfg.norm)
    if btype == "rwkv6":
        y, new_cm = blocks.rwkv6_channel_mix(
            hn, lp["ffn"], state=None if prefill else cache["cmix"],
            return_state=True)
        new_mix = {"mix": new_mix, "cmix": new_cm}
    elif cfg.moe is not None:
        y, _ = moe_lib.moe_ffn(hn, lp["ffn"], cfg)
        if cfg.moe.num_shared:
            y = y + blocks.ffn(hn, lp["ffn"]["shared"], cfg)
    else:
        y = blocks.ffn(hn, lp["ffn"], cfg)
    return h + y, new_mix


def _write_back(dst, src) -> None:
    """Copy a decode step's new block state ``src`` into ``dst``, the
    stacked cache's views for that layer, leaf by leaf (a leaf the block
    updated in place is ``dst`` itself and is skipped)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _write_back(v, src[k])
    elif dst is not src:
        dst.copy_(src)


def _backbone(params, h, cfg: ArchConfig, positions, mode: str,
              caches=None, pos=None, max_len: int = 0, enc_h=None,
              segments_key: str = "segments", segments=None):
    """Every layer of ``params[segments_key]`` (laid out as ``segments``,
    default ``segments_for(cfg)``) in order.  Returns (h, caches): prefill
    builds stacked caches; decode updates ``caches`` in place and returns
    it; encode has none."""
    new_caches = []
    for i, (pattern, count) in enumerate(segments or segments_for(cfg)):
        seg_p = params[segments_key][i]
        seg_c = caches[i] if caches is not None else None
        per_layer = []
        for j in range(count):
            ncs = []
            for si, btype in enumerate(pattern):
                lp = tree_map(lambda x: x[j], seg_p[si])
                c_in = (tree_map(lambda x: x[j], seg_c[si])
                        if seg_c is not None else None)
                h, nc = _apply_layer(h, lp, btype, cfg, positions, mode,
                                     cache=c_in, pos=pos, max_len=max_len,
                                     enc_h=enc_h)
                if mode == "decode":
                    _write_back(c_in, nc)
                ncs.append(nc)
            per_layer.append(tuple(ncs))
        if mode == "decode":
            new_caches.append(seg_c)
        elif mode == "prefill":
            new_caches.append(_stack_trees(per_layer))
    return h, tuple(new_caches)


# ---------------------------------------------------------------------------
# Embedding / head.
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ArchConfig):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def _lm_head(h, params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"])
    else:
        logits = radix_lib.maybe_radix_matmul(h, params["unembed"], cfg=cfg)
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


def _input_h(params, batch, cfg: ArchConfig):
    """(h, labels) from a batch dict: ``tokens`` (B, S + 1), or for an
    embedding-input arch ``embeds`` (B, S, d) (and ``labels``, which
    serving does not need); learned positions added."""
    if cfg.embedding_inputs:
        h, labels = batch["embeds"].to(_dt(cfg)), batch.get("labels")
    else:
        tokens = batch["tokens"]
        h, labels = _embed(params, tokens[:, :-1], cfg), tokens[:, 1:]
    if cfg.pos_embed == "learned":
        h = h + params["pos_embed"][:h.shape[1]][None].to(h.dtype)
    return h, labels


def _encode_whisper(params, enc_embeds, cfg: ArchConfig):
    """The encoder: (B, encoder_ctx, d) frame embeddings plus learned
    positions through the non-causal ``enc_segments`` stack, then its
    final norm."""
    dt = _dt(cfg)
    h = enc_embeds.to(dt) + params["enc_pos_embed"][None].to(dt)
    pos = _positions(cfg, h.shape[0], h.shape[1], device=h.device)
    h, _ = _backbone(params, h, cfg, pos, "encode",
                     segments_key="enc_segments",
                     segments=((("attn",), cfg.encoder_layers),))
    return blocks.norm(h, params["enc_final_norm"], cfg.norm)


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


def prefill(params, batch, cfg: ArchConfig, max_len: int = 0, *,
            true_len: Optional[int] = None):
    """Process the prompt; returns (last-token logits (B, V), caches).

    ``batch["tokens"]`` is (B, S + 1) (the last column is the label of the
    last position, as the reference's ``_input_h`` consumes it); an
    embedding-input arch takes ``batch["embeds"]`` (B, S, d) instead, and
    an encoder-decoder also ``batch["enc_embeds"]`` (B, encoder_ctx, d).
    ``max_len`` sizes the decode cache (default: prompt length).
    ``true_len`` gathers the last-token state at ``true_len - 1`` of a
    right-padded prompt (bucketed prefill: exact for pure full-attention
    stacks, since the causal mask hides the pads; not for recurrent or
    windowed blocks, whose state would absorb them)."""
    h, _ = _input_h(params, batch, cfg)
    b, s_len = h.shape[0], h.shape[1]
    max_len = max_len or s_len
    enc_h = None
    if cfg.encoder_layers:
        enc_h = _encode_whisper(params, batch["enc_embeds"], cfg)
    positions = _positions(cfg, b, s_len, device=h.device)
    h, caches = _backbone(params, h, cfg, positions, "prefill",
                          max_len=max_len, enc_h=enc_h)
    # ring-buffer alignment: position p must live at slot p % window
    caches = _roll_window_caches(caches, cfg, s_len)
    idx = s_len if true_len is None else int(true_len)
    h = blocks.norm(h[:, idx - 1:idx, :], params["final_norm"], cfg.norm)
    logits = _lm_head(h, params, cfg)[:, 0]
    return logits, caches


def _roll_window_caches(caches, cfg: ArchConfig, s_len: int):
    """After prefill a windowed (ring) cache holds the last W positions in
    order from slot 0; decode expects position p at slot p % W."""
    if "local_attn" not in cfg.layer_types:
        return caches
    out = []
    for (pattern, _), seg_c in zip(segments_for(cfg), caches):
        slots = []
        for btype, c in zip(pattern, seg_c):
            if btype == "local_attn":
                w = c["k"].shape[2]           # stacked (count, B, W, ...)
                shift = s_len % w if s_len > w else 0
                if shift:
                    c = {k: torch.roll(v, shift, dims=2) if v.ndim >= 3
                         else v for k, v in c.items()}
            slots.append(c)
        out.append(tuple(slots))
    return tuple(out)


def decode_step(params, caches, tokens, pos, cfg: ArchConfig):
    """One decode step.  ``tokens`` (B, 1) ints (embeds (B, 1, d) for an
    embedding-input arch); ``pos`` the position being written (an int).
    Returns (logits (B, V), caches) with ``caches`` (attention caches and
    recurrent states) updated in place."""
    pos = int(pos)
    if cfg.embedding_inputs:
        h = tokens.to(_dt(cfg))
    else:
        h = _embed(params, tokens, cfg)
    if cfg.pos_embed == "learned":
        h = h + params["pos_embed"][pos:pos + 1][None].to(h.dtype)
    h, caches = _backbone(params, h, cfg, None, "decode", caches=caches,
                          pos=pos)
    h = blocks.norm(h, params["final_norm"], cfg.norm)
    logits = _lm_head(h, params, cfg)[:, 0]
    return logits, caches
