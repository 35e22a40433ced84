"""Model construction: init / prefill / decode from an ArchConfig (port of
``repro/lm/model.py``, the serving subset for full-attention stacks).

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
writes the new token's K/V into ``caches`` in place and returns the same
trees (see ``lm/radix.py``).

Only ``attn`` blocks with gated dense FFNs, RoPE or no position embedding
and token inputs are ported; training, MoE, recurrent blocks, windowed
attention, ungated FFNs and whisper wait (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.lm import blocks, radix as radix_lib
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


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    bad = sorted(set(cfg.layer_types) - {"attn"})
    if bad:
        raise NotImplementedError(f"block types {bad} are not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.encoder_layers or cfg.embedding_inputs:
        raise NotImplementedError(
            "encoder-decoder and embedding-input stacks are not ported yet")
    if cfg.pos_embed not in ("rope", "none"):
        raise NotImplementedError(
            f"pos_embed={cfg.pos_embed!r} is not ported yet")
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet")
    if cfg.act not in ("swiglu", "geglu"):
        raise NotImplementedError(f"act={cfg.act!r} is not ported yet")


# ---------------------------------------------------------------------------
# Initialization.
# ---------------------------------------------------------------------------


def _nrm(gen: torch.Generator, shape, scale: float, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def _init_norm(cfg: ArchConfig, count: int, device):
    shape = (count, cfg.d_model)
    if cfg.norm == "layernorm":
        return {"w": torch.ones(shape, device=device),
                "b": torch.zeros(shape, device=device)}
    if cfg.norm == "gemma_rmsnorm":
        return {"w": torch.zeros(shape, device=device)}  # scale 1 + w
    return {"w": torch.ones(shape, device=device)}


def _init_layers(gen, cfg: ArchConfig, count: int, device) -> dict:
    """``count`` stacked attn + gated-FFN layers, the reference's shapes
    and init scales."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    dt = _dt(cfg)
    s_in = d ** -0.5
    c = (count,)
    mix = {
        "wq": _nrm(gen, c + (d, h, hd), s_in, dt, device),
        "wk": _nrm(gen, c + (d, hkv, hd), s_in, dt, device),
        "wv": _nrm(gen, c + (d, hkv, hd), s_in, dt, device),
        "wo": _nrm(gen, c + (h, hd, d), (h * hd * 2 * cfg.n_layers) ** -0.5,
                   dt, device),
    }
    ffn = {"w_gate": _nrm(gen, c + (d, f), s_in, dt, device),
           "w_up": _nrm(gen, c + (d, f), s_in, dt, device),
           "w_down": _nrm(gen, c + (f, d), (f * 2 * cfg.n_layers) ** -0.5,
                          dt, device)}
    return {"ln1": _init_norm(cfg, count, device),
            "ln2": _init_norm(cfg, count, device), "mix": mix, "ffn": ffn}


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` (its device must be
    ``device``'s), with the reference's tree, shapes and init scales
    (not its bits: ``carry.lm_params_from_numpy`` brings those across)."""
    check_supported(cfg)
    device = torch.device("cpu" if device is None else device)
    dt = _dt(cfg)
    p: Dict[str, Any] = {
        "embed": _nrm(generator, (cfg.vocab, cfg.d_model),
                      cfg.d_model ** -0.5, dt, device)}
    p["segments"] = tuple(
        tuple(_init_layers(generator, cfg, count, device) for _ in pattern)
        for pattern, count in segments_for(cfg))
    p["final_norm"] = {k: v[0] for k, v in
                       _init_norm(cfg, 1, device).items()}
    if not cfg.tie_embeddings:
        p["unembed"] = _nrm(generator, (cfg.d_model, cfg.vocab),
                            cfg.d_model ** -0.5, dt, device)
    return p


def radixify_params(params: dict, cfg: ArchConfig) -> dict:
    """Quantize the serving-path weights (dense FFN matmuls and an untied
    unembed, plus the QKV/out projections under ``cfg.radix_attn``) to
    int8 levels + scales.  Attention projections are stored over their
    flattened 2-D matmul view: wq/wk/wv (..., d, H, hd) -> (..., d, H*hd),
    wo (..., H, hd, d) -> (..., H*hd, d).  Other leaves are shared."""
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
                 cache=None, pos=None, max_len: int = 0):
    """One block: attention + dense FFN, each with its pre-norm and
    residual.  ``mode="prefill"`` returns the layer's new cache (K/V
    padded to ``max_len`` and encoded); ``"decode"`` updates ``cache`` in
    place.  Returns (h, cache)."""
    if btype != "attn":
        raise NotImplementedError(f"block type {btype!r} is not ported yet")
    hn = blocks.norm(h, lp["ln1"], cfg.norm)
    if mode == "prefill":
        mix, (k, v) = blocks.attention(hn, lp["mix"], cfg, positions,
                                       return_kv=True)
        pad = max_len - k.shape[1]
        if pad:
            z = torch.zeros((k.shape[0], pad) + tuple(k.shape[2:]),
                            dtype=k.dtype, device=k.device)
            k = torch.cat([k, z], 1)
            v = torch.cat([v, z], 1)
        new_cache = radix_lib.encode_cache_bulk(
            k.to(_dt(cfg)), v.to(_dt(cfg)), cfg, _dt(cfg))
    elif mode == "decode":
        mix, new_cache = blocks.decode_attention(hn, lp["mix"], cfg, cache,
                                                 pos)
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    h = h + mix
    h = h + blocks.ffn(blocks.norm(h, lp["ln2"], cfg.norm), lp["ffn"], cfg)
    return h, new_cache


def _backbone(params, h, cfg: ArchConfig, positions, mode: str,
              caches=None, pos=None, max_len: int = 0):
    """Every layer in order.  Returns (h, caches): prefill builds stacked
    caches; decode updates ``caches`` in place and returns it."""
    new_caches = []
    for i, (pattern, count) in enumerate(segments_for(cfg)):
        seg_p = params["segments"][i]
        seg_c = caches[i] if caches is not None else None
        per_layer = []
        for j in range(count):
            ncs = []
            for si, btype in enumerate(pattern):
                lp = tree_map(lambda x: x[j], seg_p[si])
                c_in = (tree_map(lambda x: x[j], seg_c[si])
                        if seg_c is not None else None)
                h, nc = _apply_layer(h, lp, btype, cfg, positions, mode,
                                     cache=c_in, pos=pos, max_len=max_len)
                ncs.append(nc)
            per_layer.append(tuple(ncs))
        if mode == "decode":
            new_caches.append(seg_c)
        else:
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
    return torch.arange(s_len, device=device).expand(b, s_len)


def _input_h(params, batch, cfg: ArchConfig):
    """(h, labels) from a batch dict of tokens."""
    tokens = batch["tokens"]
    return _embed(params, tokens[:, :-1], cfg), tokens[:, 1:]


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode.
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """Zeros caches, one stacked entry per segment slot."""
    check_supported(cfg)
    caches = []
    for pattern, count in segments_for(cfg):
        slots = []
        for _ in pattern:
            e = radix_lib.init_cache_entry(cfg, batch, max_len, _dt(cfg),
                                           device=device)
            slots.append({k: v.expand((count,) + tuple(v.shape)).clone()
                          for k, v in e.items()})
        caches.append(tuple(slots))
    return tuple(caches)


def prefill(params, batch, cfg: ArchConfig, max_len: int = 0, *,
            true_len: Optional[int] = None):
    """Process the prompt; returns (last-token logits (B, V), caches).

    ``batch["tokens"]`` is (B, S + 1) (the last column is the label of the
    last position, as the reference's ``_input_h`` consumes it).
    ``max_len`` sizes the decode cache (default: prompt length).
    ``true_len`` gathers the last-token state at ``true_len - 1`` of a
    right-padded prompt (bucketed prefill: exact for pure full-attention
    stacks, since the causal mask hides the pads)."""
    h, _ = _input_h(params, batch, cfg)
    b, s_len = h.shape[0], h.shape[1]
    max_len = max_len or s_len
    positions = _positions(cfg, b, s_len, device=h.device)
    h, caches = _backbone(params, h, cfg, positions, "prefill",
                          max_len=max_len)
    idx = s_len if true_len is None else int(true_len)
    h = blocks.norm(h[:, idx - 1:idx, :], params["final_norm"], cfg.norm)
    logits = _lm_head(h, params, cfg)[:, 0]
    return logits, caches


def decode_step(params, caches, tokens, pos, cfg: ArchConfig):
    """One decode step.  ``tokens`` (B, 1) ints; ``pos`` the position being
    written (an int).  Returns (logits (B, V), caches) with ``caches``
    updated in place."""
    h = _embed(params, tokens, cfg)
    h, caches = _backbone(params, h, cfg, None, "decode", caches=caches,
                          pos=int(pos))
    h = blocks.norm(h, params["final_norm"], cfg.norm)
    logits = _lm_head(h, params, cfg)[:, 0]
    return logits, caches
