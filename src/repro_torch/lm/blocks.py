"""Building blocks of the LM zoo (port of ``repro/lm/blocks.py``: norms,
RoPE and Qwen2-VL's M-RoPE, query-chunked attention (causal with an
optional sliding window, non-causal, or cross-attention over encoder
K/V), decode attention over the KV cache or its ring buffer and over a
cross-attention cache, the dense FFNs, the Griffin RG-LRU block and the
RWKV-6 time and channel mix).

Every function takes (params-dict, inputs) tensors, as the reference
does.  With ``tp`` (a ``parallel.tp.TP``, the mesh's 'model' layout) a
block takes this rank's shards of its weights (``tp.shard_params``) and
its input whole (``TP.enter``), computes its share of the block, and
returns the block's output summed over 'model' (``TP.exit``): the
QKV projections are column-parallel over the heads (or over head_dim
where the heads do not divide the axis: K and V's head_dim is gathered
before RoPE, the scores and the KV quantization; under sequence
parallelism each rank attends for its own rows, q exchanged over
head_dim by an all-to-all, else q is gathered too), the
output projection row-parallel; the FFNs' up/gate column- and down
row-parallel; RG-LRU's width split over 'model'; RWKV-6's heads split
over 'model', or where they do not divide it, each head's key dim (the
counterpart of the reference's ``_shard_last_over_model``: the wkv
output is then a sum over the ranks).  Decode attention over a KV cache
whose slots are split over 'model' attends over this rank's slots and
merges the ranks' softmax states (flash-decoding, the reference's
sequence-parallel contraction).

Layouts are the reference's: activations (B, S, d), q/k/v
(B, S, H, hd), the KV cache ``{k, v}`` (B, S_max, Hkv, hd) plus radix
scales, positions (B, S) or (3, B, S) for M-RoPE.  Prefill attention is
plain tensor code (the reference's is plain jnp, not a Pallas kernel);
decode self-attention over a radix cache with ``packed_attn`` runs the
decode-attention kernel, cross-attention stays plain as in the
reference.  The recurrences are tensor code too: RG-LRU's prefill is a
log-depth scan, RWKV-6's a loop over chunks of attention-like products.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.lm import radix as radix_lib
from repro_torch.lm.config import ArchConfig

__all__ = ["norm", "rope_apply", "attention", "decode_mask",
           "decode_attention", "ffn", "conv1d_causal", "rglru_block",
           "rwkv6_block", "rwkv6_channel_mix"]


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind in ("rmsnorm", "gemma_rmsnorm"):
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + 1e-6)
        w = p["w"].to(torch.float32)
        scale = (1.0 + w) if kind == "gemma_rmsnorm" else w
        return (xf * scale).to(x.dtype)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (xf * p["w"] + p["b"]).to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE).
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, hd: int, theta: float
                 ) -> torch.Tensor:
    """(..., S) positions -> (..., S, hd//2) angles."""
    half = torch.arange(0, hd // 2, dtype=torch.float32,
                        device=positions.device)
    expo = -half / torch.tensor(float(hd // 2), device=positions.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), expo)
    return positions.to(torch.float32)[..., None] * freq


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None
               ) -> torch.Tensor:
    """Rotate (B, S, H, hd) by positions (B, S), or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the hd//2 rotary frequencies are split into
    sections (temporal, height, width), each taking its angle from its
    own positional stream; text tokens carry identical streams, so M-RoPE
    equals RoPE on text."""
    hd = x.shape[-1]
    if mrope_sections is not None:
        if positions.ndim != 3:
            raise ValueError(f"M-RoPE wants (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        angles = _rope_angles(positions, hd, theta)       # (3, B, S, hd/2)
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(angles[i, ..., start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                    # (B, S, hd/2)
    else:
        ang = _rope_angles(positions, hd, theta)          # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (prefill, encoder): query-chunked, GQA; causal (optionally
# windowed), non-causal or cross-attention.
# ---------------------------------------------------------------------------


def _attn_proj(x, w, cfg: ArchConfig, tp=None, key: str = ""):
    """x (B,S,d) @ w -> (B,S,H,hd).  ``w`` is a (d,H,hd) tensor, or under
    ``cfg.radix_attn`` a quantize_weight dict over the (d, H*hd) view;
    under ``tp`` this rank's heads (or head_dim slices: hd is then the
    local ``hd / model``)."""
    if tp is not None and tp.kind(key) == "replicated":
        x = tp.replicated(x)
    if isinstance(w, dict):
        y = radix_lib.maybe_radix_matmul(x, w, cfg=cfg)
        hd = cfg.hd // tp.n if tp is not None and tp.kind(key) == \
            "head_dim" else cfg.hd
        return y.reshape(y.shape[:-1] + (-1, hd))
    return torch.einsum("bsd,dhk->bshk", x, w)


def _out_proj(o, w, cfg: ArchConfig, tp=None):
    """(B,S,H,hd) @ wo -> (B,S,d); dict = flattened (H*hd, d) radix view.
    Under ``tp`` ``o`` and ``wo`` are this rank's heads (or head_dim
    slices) and the product is summed over 'model'."""
    if isinstance(w, dict):
        return radix_lib.maybe_radix_matmul(
            o.reshape(o.shape[:-2] + (-1,)), w, cfg=cfg, tp=tp)
    y = torch.einsum("bshk,hkd->bsd", o, w)
    return y if tp is None else tp.exit(y)


def _qkv(x, p, cfg: ArchConfig, tp=None):
    q = _attn_proj(x, p["wq"], cfg, tp, "wq")              # (B,S,H,hd)
    k = _attn_proj(x, p["wk"], cfg, tp, "wk")              # (B,S,Hkv,hd)
    v = _attn_proj(x, p["wv"], cfg, tp, "wv")
    return q, k, v


def _local_heads(cfg: ArchConfig, tp):
    """The query heads [h0, h1) this rank computes: its own under a
    column split of ``wq``, else all of them."""
    if tp is None or tp.kind("wq") != "column":
        return 0, cfg.n_heads
    hl = cfg.n_heads // tp.n
    return tp.rank * hl, (tp.rank + 1) * hl


def _tp_heads(q, k, v, cfg: ArchConfig, tp):
    """Under ``tp``: (q of this rank's heads [h0, h1) with whole
    head_dim, K and V with whole head_dim, the slice of K/V's heads those
    query heads read, or None where K/V hold just this rank's kv heads).
    A head_dim split is gathered here (before RoPE and the scores)."""
    h0, h1 = _local_heads(cfg, tp)
    q_local = h1 - h0 < cfg.n_heads
    if tp.kind("wq") == "head_dim":
        q = tp.gather(q, -1)
    gather = tp.gather_sum if q_local else tp.gather
    if tp.kind("wk") == "head_dim":
        k, v = gather(k, -1), gather(v, -1)
    if not q_local or tp.kind("wk") == "column":
        return q, k, v, None
    g = cfg.n_heads // cfg.n_kv_heads
    return q, k, v, slice(h0 // g, (h1 - 1) // g + 1)


def _tp_out(o, p, cfg: ArchConfig, tp):
    """The output projection of (B,S,H_loc,hd) ``o`` (this rank's heads,
    or all of them) under ``tp``: row-parallel over heads or head_dim,
    or every rank's whole product where ``wo`` is replicated."""
    kind = tp.kind("wo")
    if kind == "row":
        if o.shape[2] == cfg.n_heads:
            o = tp.piece(o, 2)
        return _out_proj(o, p["wo"], cfg, tp)
    if kind == "row_hd":
        return _out_proj(tp.piece(o, 3), p["wo"], cfg, tp)
    return tp.exit_whole(_out_proj(tp.replicated(o), p["wo"], cfg))


def _rows_path(cfg: ArchConfig, tp, cross: bool) -> bool:
    """Whether attention under ``tp`` attends for this rank's sequence
    piece of the queries only: self-attention whose q, k and v split
    head_dim over 'model' (the heads do not divide it) while the residual
    stream is split over the sequence (``tp.seq``: train and prefill, a
    length that divides 'model')."""
    return (tp is not None and tp.seq and not cross
            and all(tp.kind(w) == "head_dim" for w in ("wq", "wk", "wv"))
            and tp.kind("wo") == "row_hd")


def _rows_of(q, tp):
    """(B, S, H, hd/n), this rank's head_dim piece of every row, ->
    (B, S/n, H, hd), every head_dim column of this rank's rows: one
    all-to-all over 'model' (rank i holds head_dim piece i)."""
    b, s, h, e = q.shape
    n = tp.n
    x = tp.exchange(q.reshape(b, n, s // n, h, e).movedim(1, 0).contiguous())
    return x.movedim(0, 3).reshape(b, s // n, h, n * e)


def _piece_of(o, tp):
    """The inverse of :func:`_rows_of`: (B, S/n, H, hd) of this rank's
    rows -> (B, S, H, hd/n), this rank's head_dim piece of every row."""
    b, sl, h, hd = o.shape
    n = tp.n
    x = tp.exchange(o.reshape(b, sl, h, n, hd // n).movedim(3, 0)
                    .contiguous())
    return x.movedim(0, 1).reshape(b, n * sl, h, hd // n)


# query rows each prefill/train attention call computed, by path: "rows"
# (this rank's sequence piece, :func:`_rows_path`) or "whole"
ATTN_ROWS = {"rows": 0, "whole": 0, "rows_calls": 0, "whole_calls": 0}


def _gqa_scores(q, k):
    """(B,Sq,H,hd) x (B,Sk,Hkv,hd) -> (B,H,Sq,Sk) without repeating K."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k)
    return s.reshape(b, h, sq, s.shape[-1])


def _gqa_out(probs, v):
    """(B,H,Sq,Sk) x (B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    b, h, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, h // hkv, sq, sk)
    o = torch.einsum("bhgqs,bshk->bqhgk", pg, v)
    return o.reshape(b, sq, h, o.shape[-1])


def attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
              positions: torch.Tensor, *, window: int = 0,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              return_kv: bool = False, causal: bool = True, tp=None):
    """Self-attention, or cross-attention over ``cross_kv`` (the encoder's
    (B, S_enc, Hkv, hd) K and V, never masked), query-chunked: scores
    exist for ``cfg.attn_chunk`` queries at a time.  ``causal`` masks
    later keys; ``window`` > 0 is local attention: a query sees the keys
    less than ``window`` positions back.  Query positions are
    ``positions[0]``, or ``positions[0, 0]`` of (3, B, S) M-RoPE
    streams.  Under ``tp`` (``x`` whole, ``cross_kv`` from this rank's
    ``wk``/``wv``) the output is summed over 'model' and ``return_kv``
    gives K and V of every head.

    Where the heads split head_dim over 'model' under sequence
    parallelism (:func:`_rows_path`) each rank attends for its own S/n
    query rows against the whole K and V: an all-to-all hands it every
    head_dim column of its rows' q and hands back its head_dim piece of
    every row's output for the row-parallel ``wo``.  Each row is
    computed as on one device, in the one-device query chunks where
    S/n holds a whole number of them."""
    b, s_len, _ = x.shape
    hd = cfg.hd
    if cross_kv is None:
        q, k, v = _qkv(x, p, cfg, tp)
    else:
        q = _attn_proj(x, p["wq"], cfg, tp, "wq")
        k, v = cross_kv
        causal = False
    rows = _rows_path(cfg, tp, cross_kv is not None)
    q_positions = positions
    kv_heads = None
    if rows:
        q = _rows_of(q, tp)
        # each rank's rows read every key: their gradients summed
        k, v = tp.gather_sum(k, -1), tp.gather_sum(v, -1)
        r0 = tp.rank * q.shape[1]
        q_positions = positions[..., r0:r0 + q.shape[1]]
    elif tp is not None:
        q, k, v, kv_heads = _tp_heads(q, k, v, cfg, tp)
    if cross_kv is None and cfg.pos_embed == "rope":
        sec = cfg.mrope_sections
        q = rope_apply(q, q_positions, cfg.rope_theta, sec)
        k = rope_apply(k, positions, cfg.rope_theta, sec)
    kv = k, v
    if kv_heads is not None:
        k, v = k[:, :, kv_heads], v[:, :, kv_heads]

    scale = hd ** -0.5
    n_q = q.shape[1]
    path = "rows" if rows else "whole"
    ATTN_ROWS[path] += n_q
    ATTN_ROWS[path + "_calls"] += 1
    chunk = min(cfg.attn_chunk, s_len) if cfg.attn_chunk else s_len
    if s_len % chunk or n_q % chunk:
        chunk = n_q            # irregular lengths: single pass
    kpos = torch.arange(k.shape[1], device=x.device)

    def attend_chunk(qc, qpos):
        s = _gqa_scores(qc, k).to(torch.float32) * scale   # (B,H,cq,Sk)
        if causal:
            m = qpos[:, None] >= kpos[None, :]
            if window:
                m = m & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(m[None, None], s, -1e30)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        return _gqa_out(pr, v)

    qpos_all = (q_positions[0] if q_positions.ndim == 2
                else q_positions[0, 0])
    o = torch.cat([attend_chunk(q[:, c0:c0 + chunk], qpos_all[c0:c0 + chunk])
                   for c0 in range(0, n_q, chunk)], dim=1)
    if tp is None:
        out = _out_proj(o, p["wo"], cfg)
    elif rows:
        out = _out_proj(_piece_of(o, tp), p["wo"], cfg, tp)
    else:
        out = _tp_out(o, p, cfg, tp)
        k, v = kv
        if return_kv and k.shape[2] < cfg.n_kv_heads:
            # every kv head (no gradient: the cache's)
            k, v = tp.gather(k, 2), tp.gather(v, 2)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode attention: one new token against the KV cache.
# ---------------------------------------------------------------------------


def decode_mask(pos, s_len: int, window: int = 0, device=None,
                offset: int = 0) -> torch.Tensor:
    """Valid-slot mask (B or 1, s_len) bool for one decode step at ``pos``
    (an int, or a (B,) tensor of positions), of the slots ``offset`` ..
    ``offset + s_len - 1`` (a rank's piece of a cache whose slots are
    split over 'model').

    Full attention: slot i valid iff i <= pos.  Windowed ring buffer: slot
    i holds absolute position pos - ((pos - i) % window); only never-
    written slots (abs < 0) are masked."""
    if torch.is_tensor(pos):
        device = pos.device
        pos = pos.reshape(-1, 1)
    else:
        pos = int(pos)                  # a host int: no copy to the device
    slots = torch.arange(offset, offset + s_len, device=device)[None, :]
    if window:
        return pos - torch.remainder(pos - slots, window) >= 0
    return slots <= pos


def _whole_heads(t, kind: str, tp):
    """A decode step's q/k/v of every head, whole head_dim, from this
    rank's column (heads) or head_dim piece."""
    if kind == "column":
        return tp.gather(t, 2)
    if kind == "head_dim":
        return tp.gather(t, -1)
    return t


def _float_partials(q, k, v, valid, hd: int):
    """Softmax state (m, l, o) of (B,1,H,hd) ``q`` over the (B,S,Hkv,hd)
    float ``k``/``v`` of this rank's slots (``valid`` (B,S) or None), as
    :func:`kernels.radix_attn.combine_splits` takes one split per row of
    (B*H): m/l (B*H, 1, 1, 1), o (B*H, 1, 1, hd), all float32."""
    s = _gqa_scores(q, k).to(torch.float32) * hd ** -0.5     # (B,H,1,S)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, -1e30)
    m = s.amax(-1, keepdim=True)
    pr = torch.exp(s - m)
    if valid is not None:
        pr = torch.where(valid[:, None, None, :], pr, 0.0)
    l = pr.sum(-1, keepdim=True)
    o = _gqa_out(pr, v.to(torch.float32))                   # (B,1,H,hd)
    b, h = q.shape[0], q.shape[2]
    return (m.reshape(b * h, 1, 1, 1), l.reshape(b * h, 1, 1, 1),
            o.reshape(b * h, 1, 1, hd))


def _decode_tp(x, p, cfg: ArchConfig, cache: dict, pos: int, window: int,
               cross: bool, tp):
    """:func:`decode_attention` under ``tp``: every head's q (and the new
    token's K/V, written by the rank that holds its slot), this rank's
    slots of the cache, the ranks' softmax states merged in the decode
    kernel's order (the packed kernel's partials, or the float states),
    then the row-parallel output projection."""
    from repro_torch.kernels import radix_attn as ra

    b, hd = x.shape[0], cfg.hd
    q = _whole_heads(_attn_proj(x, p["wq"], cfg, tp, "wq"), tp.kind("wq"),
                     tp)
    s_loc = cache["k"].shape[1]
    # this rank holds a piece of the slots: merge the ranks' states (one
    # rank holds them all and attends as one device does)
    split = tp.kv_split and tp.n > 1
    length = s_loc * tp.n if split else s_loc
    offset = tp.rank * s_loc if split else 0
    if cross:
        k, v = cache["k"], cache["v"]
        valid = None
    else:
        knew = _whole_heads(_attn_proj(x, p["wk"], cfg, tp, "wk"),
                            tp.kind("wk"), tp)
        vnew = _whole_heads(_attn_proj(x, p["wv"], cfg, tp, "wv"),
                            tp.kind("wv"), tp)
        if cfg.pos_embed == "rope":
            shape = (b, 1) if cfg.mrope_sections is None else (3, b, 1)
            posb = torch.full(shape, int(pos), device=x.device)
            q = rope_apply(q, posb, cfg.rope_theta, cfg.mrope_sections)
            knew = rope_apply(knew, posb, cfg.rope_theta,
                              cfg.mrope_sections)
        cache = radix_lib.cache_update(cache, knew, vnew, pos, cfg,
                                       window=window, offset=offset)
        valid = decode_mask(int(pos), s_loc, window, device=x.device,
                            offset=offset).expand(b, s_loc)
        if radix_lib.packed_attn_enabled(cfg):
            if not split:
                o = radix_lib.packed_decode_attention(q[:, 0], cache, valid,
                                                      cfg)
            else:
                part = radix_lib.packed_decode_attention(
                    q[:, 0], cache, valid, cfg, partials=True,
                    splits=(ra.split_slots(length), ra.MAX_SPLITS))
                hkv = cfg.n_kv_heads
                o = ra.merge_partials(
                    tp.gather(part[None], 0).unbind(0), b * hkv,
                    cfg.n_heads // hkv, hd)
            o = o.reshape(b, 1, cfg.n_heads, hd).to(x.dtype)
            return _tp_out(o, p, cfg, tp), cache
        k, v = radix_lib.cache_read(cache, cfg)
    if not split:
        return _tp_out(_attend(q, k, v, valid, hd, x.dtype), p, cfg,
                       tp), cache
    m, l, o = _float_partials(q, k, v, valid, hd)
    m, l, o = (tp.gather(t, 1) for t in (m, l, o))
    o = ra.combine_splits(m, l, o).reshape(b, 1, cfg.n_heads, hd)
    return _tp_out(o.to(x.dtype), p, cfg, tp), cache


def decode_attention(x: torch.Tensor, p: dict, cfg: ArchConfig, cache: dict,
                     pos: int, *, window: int = 0, cross: bool = False,
                     tp=None):
    """x (B, 1, d); cache {k, v} (B, S_max, Hkv, hd) (+ scales if radix),
    updated in place at ``pos`` (a ring buffer of ``window`` slots, written
    at ``pos % window``, when ``window`` > 0).  ``cross``: attend over a
    cross-attention cache (the encoder's float K/V, which stays float
    under ``radix_kv``), unmasked and not written.  Returns (out
    (B, 1, d), cache).

    Under ``tp`` the cache holds this rank's slots where ``tp.kv_split``
    (the cache's placement splits its slots over 'model'), else all of
    them, and the output is summed over 'model'."""
    if tp is not None:
        return _decode_tp(x, p, cfg, cache, pos, window, cross, tp)
    b = x.shape[0]
    hd = cfg.hd
    if cross:
        q = _attn_proj(x, p["wq"], cfg)
        k, v = cache["k"], cache["v"]
        valid = None
    else:
        q, knew, vnew = _qkv(x, p, cfg)
        if cfg.pos_embed == "rope":
            shape = (b, 1) if cfg.mrope_sections is None else (3, b, 1)
            posb = torch.full(shape, int(pos), device=x.device)
            q = rope_apply(q, posb, cfg.rope_theta, cfg.mrope_sections)
            knew = rope_apply(knew, posb, cfg.rope_theta, cfg.mrope_sections)
        cache = radix_lib.cache_update(cache, knew, vnew, pos, cfg,
                                       window=window)
        s_len = cache["k"].shape[1]
        valid = decode_mask(int(pos), s_len, window, device=x.device)
        if radix_lib.packed_attn_enabled(cfg):
            # the kernel reads the uint8 levels directly: no
            # (B, S, Hkv, hd) float K/V is materialized
            o = radix_lib.packed_decode_attention(
                q[:, 0], cache, valid.expand(b, s_len), cfg)
            o = o[:, None].to(x.dtype)                     # (B,1,H,hd)
            return _out_proj(o, p["wo"], cfg), cache
        k, v = radix_lib.cache_read(cache, cfg)
    return _out_proj(_attend(q, k, v, valid, hd, x.dtype), p["wo"],
                     cfg), cache


def _attend(q, k, v, valid, hd: int, dtype):
    """(B,1,H,hd) ``q`` over the float (B,S,Hkv,hd) ``k``/``v`` (``valid``
    (B,S) or None): softmax in float32, the probabilities in ``dtype``."""
    s = _gqa_scores(q, k).to(torch.float32) * hd ** -0.5  # (B,H,1,S)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(dtype)
    return _gqa_out(pr, v)                                 # (B,1,H,hd)


# ---------------------------------------------------------------------------
# Channel mixing: dense FFN variants.
# ---------------------------------------------------------------------------


def ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """Dense FFN: gated (SwiGLU, GeGLU), or ungated (``gelu_mlp``,
    ``relu_sq``); ``jax.nn.gelu`` is the tanh approximation.  Under
    ``tp``: this rank's d_ff columns of the up/gate products and its rows
    of the down product, summed over 'model' (every rank's whole FFN
    where d_ff does not divide the axis)."""
    matmul = functools.partial(radix_lib.maybe_radix_matmul, cfg=cfg)
    whole = tp is not None and tp.kind("w_up") == "replicated"
    if whole:
        x = tp.replicated(x)
    if cfg.act in ("swiglu", "geglu"):
        # on the radix fused path x is quantized once for both products
        # and h is the down product's levels, act(g) * u never written
        xin = radix_lib.radix_input(x, p["w_gate"], cfg)
        g = matmul(xin, p["w_gate"])
        u = matmul(xin, p["w_up"])
        h = radix_lib.glu_input(g, u, p["w_down"], cfg,
                                tp=None if whole else tp)
    elif cfg.act == "gelu_mlp":
        h = F.gelu(matmul(x, p["w_up"]), approximate="tanh")
    elif cfg.act == "relu_sq":
        h = torch.square(F.relu(matmul(x, p["w_up"])))
    else:
        raise ValueError(cfg.act)
    if tp is None:
        return matmul(h, p["w_down"])
    if whole:
        return tp.exit_whole(matmul(h, p["w_down"]))
    return matmul(h, p["w_down"], tp=tp)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma).
# ---------------------------------------------------------------------------


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B, S, C), w (K, C).  With ``state``
    (B, K-1, C) runs in streaming mode and returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s_len = x.shape[1]
    y = sum(xp[:, i:i + s_len, :] * w[i] for i in range(k))
    if state is None:
        return y
    return y, xp[:, -(k - 1):, :]


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor,
                h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over S, (B, S, W), as a log-depth
    inclusive scan of the reference's combine ``(a1 a2, a2 b1 + b2)``
    over doubling offsets (Hillis-Steele: ceil(log2 S) rounds of tensor
    ops).  Its float order differs from ``lax.associative_scan``'s."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]],
                       dim=1)
    s_len, d = a.shape[1], 1
    while d < s_len:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return bx


def rglru_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                state: Optional[dict] = None, *, return_state: bool = False,
                tp=None):
    """Griffin recurrent block: [linear -> conv -> RG-LRU] * gate -> out.

    r, i = sigmoid(W_a u), sigmoid(W_x u); a = a_max^r with
    log a_max = -8 softplus(lambda); h = a h_- + sqrt(1 - a^2) (i u).
    Prefill scans over S; decode (``state`` {"conv": (B, K-1, W),
    "h": (B, W)}, S == 1) is one step.  Under ``tp`` the width W is split
    over 'model' (this rank's channels of the gate, the conv, the gates
    ``W_a``/``W_x`` of the whole ``u``, the scan and the state; ``w_out``
    row-parallel), or every rank runs the whole block where W does not
    divide the axis."""
    whole = tp is not None and tp.kind("w_rec_in") == "replicated"
    if whole:
        x = tp.replicated(x)
    k = p["conv_w"].shape[0]
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")   # (B,S,W)
    u_pre = x @ p["w_rec_in"]
    if state is None:
        u = conv1d_causal(u_pre, p["conv_w"])
        # streaming conv state = the last K-1 raw inputs, zero-padded for
        # prompts shorter than K-1 (the conv pads with zeros alike)
        conv_state_new = (
            F.pad(u_pre, (0, 0, max(k - 1 - u_pre.shape[1], 0), 0))
            [:, -(k - 1):, :] if return_state else None)
    else:
        u, conv_state_new = conv1d_causal(u_pre, p["conv_w"], state["conv"])

    uf = u.to(torch.float32)
    uw = uf if tp is None or whole else tp.gather_sum(uf, -1)   # whole W
    r = torch.sigmoid(uw @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(uw @ p["w_x"].to(torch.float32) + p["b_x"])
    log_a_max = -8.0 * F.softplus(p["lambda_p"])             # (W,) < 0
    a = torch.exp(log_a_max * r)                             # (B,S,W)
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * (i * uf)

    if state is None:
        h = _rglru_scan(a, bx, None)
        new_state = ({"conv": conv_state_new, "h": h[:, -1, :]}
                     if return_state else None)
    else:
        h = a * state["h"][:, None, :] + bx                  # S == 1 decode
        new_state = {"conv": conv_state_new, "h": h[:, -1, :]}

    y = (h.to(x.dtype) * gate) @ p["w_out"]
    if tp is not None:
        y = tp.exit_whole(y) if whole else tp.exit(y)
    return (y, new_state) if (state is not None or return_state) else y


# ---------------------------------------------------------------------------
# RWKV-6 'Finch' time mix (data-dependent decay) + channel mix.
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """The x_{t-1} stream.  ``prev`` (B, d) is the carry for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_chunk_scan(r, k, v, w, u, chunk: int, remat_body: bool = False):
    """Chunked linear recurrence (all (B, H, S, hd), decay w in (0, 1);
    r, k, w and u may hold a slice of each head's key dim, v its whole
    value dim):

        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

    Per chunk (length C), with L = inclusive cumsum(log w) and E the
    exclusive one:

        intra:  o_t += sum_{j<t} (r_t . k_j e^{E_t - L_j}) v_j
        diag:   o_t += (r_t . u k_t) v_t
        inter:  o_t += (r_t e^{E_t}) . S_in
        state:  S_out = e^{L_C} . S_in + sum_j (k_j e^{L_C - L_j}) v_j^T

    The intra-chunk decay ``E_t - L_j`` (<= 0 for j < t) is taken in log
    space, so nothing overflows and no clip is needed.  The chunks run in
    a Python loop carrying the (B, H, hd, hd) float32 state, as the
    reference's ``lax.scan`` does.  ``remat_body`` (``cfg.rwkv_remat_chunk``)
    recomputes each chunk's (C, C, hd) intra-chunk tensors in the backward
    (``torch.utils.checkpoint`` over the chunk body) instead of keeping
    them.  Returns (o (B, H, S, hd), S_final)."""
    b, h, s_len, hd = r.shape
    if s_len % chunk:
        raise ValueError(f"S={s_len} is not a multiple of chunk={chunk}")
    n = s_len // chunk
    rs, ks, ws = (t.reshape(b, h, n, chunk, hd) for t in (r, k, w))
    vs = v.reshape(b, h, n, chunk, v.shape[-1])
    logw = torch.log(torch.clamp(ws.to(torch.float32), 1e-9, 1.0))
    cum = torch.cumsum(logw, dim=3)                          # inclusive L
    exc = cum - logw                                         # exclusive E
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device),
                     diagonal=-1)

    def body(state, rc, kc, vc, lc, ec):
        rf, kf, vf = (t.to(torch.float32) for t in (rc, kc, vc))
        diff = ec[..., :, None, :] - lc[..., None, :, :]     # (B,H,C,C,hd)
        dec = torch.exp(torch.where(tri[..., None] > 0, diff, -torch.inf))
        # a product and a sum over c: as one einsum, (t, j) become batch
        # dims of a matrix-vector product per pair
        att = (rf[..., :, None, :] * kf[..., None, :, :] * dec).sum(-1)
        o = torch.einsum("bhtj,bhjd->bhtd", att, vf)
        o = o + (rf * u * kf).sum(-1, keepdim=True) * vf     # diag bonus
        q_ = rf * torch.exp(ec)                              # to chunk start
        o = o + torch.einsum("bhtc,bhcd->bhtd", q_, state)   # inter-chunk
        lc_last = lc[..., -1:, :]                            # (B,H,1,hd)
        k_hat = kf * torch.exp(lc_last - lc)
        state = (state * torch.exp(lc_last[..., 0, :])[..., :, None]
                 + torch.einsum("bhjc,bhjd->bhcd", k_hat, vf))
        return o, state

    remat = remat_body and torch.is_grad_enabled() and r.requires_grad
    state = torch.zeros((b, h, hd, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    outs = []
    for c in range(n):
        args = (state, rs[:, :, c], ks[:, :, c], vs[:, :, c], cum[:, :, c],
                exc[:, :, c])
        if remat:
            o, state = torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False)
        else:
            o, state = body(*args)
        outs.append(o)
    return torch.cat(outs, dim=2), state


def _rwkv_step(r, k, v, w, u, s0):
    """One decode step: inputs (B, H, hd); state ``s0`` (B, H, hd, hd)
    float32.  Returns (o (B, H, hd), new state)."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    wkv = s0 + u[..., :, None] * kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhc,bhcd->bhd", rf, wkv)
    s1 = (s0 * w.to(torch.float32)[..., :, None]
          + kf[..., :, None] * vf[..., None, :])
    return o, s1


def _rwkv_mode(tp) -> str:
    """How RWKV-6's time mix splits over 'model': ``"heads"`` (the heads
    divide the axis), ``"key"`` (each head's key dim: the channels divide
    it but the heads do not), ``"whole"`` (neither), ``""`` no ``tp``."""
    if tp is None:
        return ""
    if tp.kind("u_bonus") == "column":
        return "heads"
    return "key" if tp.kind("w_r") == "column" else "whole"


def rwkv6_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                state: Optional[dict] = None, *, chunk: int = 64,
                return_state: bool = False, tp=None):
    """RWKV-6 'Finch' time mix: token shift, per-projection mu mixing,
    the low-rank data-dependent decay, the wkv recurrence, a per-head
    groupnorm and the silu(g) gate.  x (B, S, d).

    Decode (``state`` {"last_x": (B, d), "S": (B, H, hd, hd) float32},
    S == 1) runs one step of the recurrence.

    Under ``tp`` the r/k/v/g/decay projections are column-parallel and
    ``w_o`` row-parallel.  Where the heads divide 'model' a rank runs its
    heads' recurrence and state.  Where they do not, a rank runs the
    chunked scan over its slice of every head's key dim (r, k, the decay
    and the bonus; v whole), the counterpart of the reference's
    ``_shard_last_over_model``: the wkv output is a sum over the ranks,
    and the state's key rows are joined after the scan; decode then runs
    the whole (small) step on every rank."""
    b, s_len, d = x.shape
    hd = cfg.rwkv_head_dim
    mode = _rwkv_mode(tp)
    if mode == "whole":
        x = tp.replicated(x)
    prev = state["last_x"] if state is not None else None
    sx = _token_shift(x, prev) - x                           # (B,S,d)

    def mix(tag):
        mu = p[f"mu_{tag}"]
        if mode in ("heads", "key"):
            mu = tp.param(mu)        # used on this rank's columns only
        return x + sx * mu.to(x.dtype)

    r = mix("r") @ p["w_r"]
    k = mix("k") @ p["w_k"]
    v = mix("v") @ p["w_v"]
    g = F.silu(mix("g") @ p["w_g"])
    # Finch decay: w = exp(-exp(w0 + lora)) in (0, 1), data-dependent; the
    # low-rank factors are float32, so the product runs in float32 (jnp
    # promotes a bf16 operand; torch's matmul takes one dtype)
    xw = mix("w").to(torch.float32)
    if mode and mode != "whole" and tp.kind("w_dec_a") != "column":
        xw = tp.replicated(xw)
    lo = torch.tanh(xw @ p["w_dec_a"])
    if mode and mode != "whole" and tp.kind("w_dec_a") == "column":
        lo = tp.gather_sum(lo, -1)
    lora = lo @ p["w_dec_b"]
    logit = p["w_dec0"].to(torch.float32) + lora.to(torch.float32)
    w = torch.exp(-torch.exp(torch.clamp(logit, -20.0, 6.0)))  # (B,S,d)
    if mode == "key":               # every channel: each rank's key slice
        r, k, v, w = (tp.gather_sum(t, -1) for t in (r, k, v, w))

    def heads(t):
        return t.reshape(b, s_len, -1, hd).permute(0, 2, 1, 3)  # (B,H,S,hd)

    u = p["u_bonus"].to(torch.float32)                       # (H, hd)
    kslice = slice(None)
    if mode == "key" and state is None:
        c = hd // tp.n
        kslice = slice(tp.rank * c, (tp.rank + 1) * c)
    if state is None:
        chunk = min(cfg.rwkv_chunk or chunk, s_len)
        if s_len % chunk:
            chunk = s_len
        o, s_fin = _rwkv_chunk_scan(
            heads(r)[..., kslice], heads(k)[..., kslice], heads(v),
            heads(w)[..., kslice], u[None, :, None, kslice], chunk,
            remat_body=cfg.rwkv_remat_chunk)
        if mode == "key":
            o = tp.reduce(o)
            if return_state:
                s_fin = tp.gather(s_fin, 2)
        new_state = ({"last_x": x[:, -1, :], "S": s_fin}
                     if return_state else None)
    else:
        o1, s1 = _rwkv_step(heads(r)[:, :, 0], heads(k)[:, :, 0],
                            heads(v)[:, :, 0], heads(w)[:, :, 0], u[None],
                            state["S"])
        o = o1[:, :, None, :]
        new_state = {"last_x": x[:, -1, :], "S": s1}

    h = o.shape[1]
    o = o.permute(0, 2, 1, 3).reshape(b, s_len, h, hd)       # (B,S,H,hd)
    of = o.to(torch.float32)                                 # per-head norm
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    o = (of - mu) * torch.rsqrt(var + 1e-5) * p["gn_w"] + p["gn_b"]
    o = o.reshape(b, s_len, h * hd).to(x.dtype)
    if mode == "key":
        o = tp.piece(o, -1)
    y = (o * g) @ p["w_o"]
    if mode == "whole":
        y = tp.exit_whole(y)
    elif mode:
        y = tp.exit(y)
    return (y, new_state) if (state is not None or return_state) else y


def rwkv6_channel_mix(x: torch.Tensor, p: dict,
                      state: Optional[dict] = None, *,
                      return_state: bool = False, tp=None):
    """RWKV channel mix: a token-shifted squared-relu MLP with a
    receptance gate.  Decode carries {"last_x": (B, d)}.  Under ``tp``
    the key product is column- and the value product row-parallel; the
    receptance gate's columns are joined before it gates the summed
    value (this rank's tokens of it under sequence parallelism)."""
    whole = tp is not None and tp.kind("w_ck") == "replicated"
    if whole:
        x = tp.replicated(x)
    prev = state["last_x"] if state is not None else None
    sx = _token_shift(x, prev) - x
    mu_k, mu_r = p["mu_ck"], p["mu_cr"]
    if tp is not None and not whole:
        mu_k, mu_r = tp.param(mu_k), tp.param(mu_r)
    xk = x + sx * mu_k.to(x.dtype)
    xr = x + sx * mu_r.to(x.dtype)
    kk = torch.square(F.relu(xk @ p["w_ck"]))
    if tp is None:
        y = torch.sigmoid(xr @ p["w_cr"]) * (kk @ p["w_cv"])
    elif whole:
        y = tp.exit_whole(torch.sigmoid(xr @ p["w_cr"]) * (kk @ p["w_cv"]))
    else:
        if tp.kind("w_cr") == "column":
            gate = torch.sigmoid(xr @ p["w_cr"])
            gate = (tp.gather_sum if tp.seq else tp.gather)(gate, -1)
        else:
            gate = torch.sigmoid(tp.replicated(xr) @ p["w_cr"])
        if tp.seq:                   # this rank's tokens
            n = gate.shape[1] // tp.n
            gate = gate[:, tp.rank * n:(tp.rank + 1) * n]
        y = gate * tp.exit(kk @ p["w_cv"])
    if state is not None or return_state:
        return y, {"last_x": x[:, -1, :]}
    return y
