"""Building blocks of the LM zoo (port of ``repro/lm/blocks.py``: norms,
RoPE and Qwen2-VL's M-RoPE, query-chunked attention (causal with an
optional sliding window, non-causal, or cross-attention over encoder
K/V), decode attention over the KV cache or its ring buffer and over a
cross-attention cache, the dense FFNs, the Griffin RG-LRU block and the
RWKV-6 time and channel mix).

Every function takes (params-dict, inputs) tensors, as the reference
does.  Layouts are the reference's: activations (B, S, d), q/k/v
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


def _attn_proj(x, w, cfg: ArchConfig):
    """x (B,S,d) @ w -> (B,S,H,hd).  ``w`` is a (d,H,hd) tensor, or under
    ``cfg.radix_attn`` a quantize_weight dict over the (d, H*hd) view."""
    if isinstance(w, dict):
        y = radix_lib.maybe_radix_matmul(x, w, cfg=cfg)
        return y.reshape(y.shape[:-1] + (-1, cfg.hd))
    return torch.einsum("bsd,dhk->bshk", x, w)


def _out_proj(o, w, cfg: ArchConfig):
    """(B,S,H,hd) @ wo -> (B,S,d); dict = flattened (H*hd, d) radix view."""
    if isinstance(w, dict):
        return radix_lib.maybe_radix_matmul(
            o.reshape(o.shape[:-2] + (-1,)), w, cfg=cfg)
    return torch.einsum("bshk,hkd->bsd", o, w)


def _qkv(x, p, cfg: ArchConfig):
    q = _attn_proj(x, p["wq"], cfg)                        # (B,S,H,hd)
    k = _attn_proj(x, p["wk"], cfg)                        # (B,S,Hkv,hd)
    v = _attn_proj(x, p["wv"], cfg)
    return q, k, v


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
              return_kv: bool = False, causal: bool = True):
    """Self-attention, or cross-attention over ``cross_kv`` (the encoder's
    (B, S_enc, Hkv, hd) K and V, never masked), query-chunked: scores
    exist for ``cfg.attn_chunk`` queries at a time.  ``causal`` masks
    later keys; ``window`` > 0 is local attention: a query sees the keys
    less than ``window`` positions back.  Query positions are
    ``positions[0]``, or ``positions[0, 0]`` of (3, B, S) M-RoPE
    streams."""
    b, s_len, _ = x.shape
    hd = cfg.hd
    if cross_kv is None:
        q, k, v = _qkv(x, p, cfg)
        if cfg.pos_embed == "rope":
            sec = cfg.mrope_sections
            q = rope_apply(q, positions, cfg.rope_theta, sec)
            k = rope_apply(k, positions, cfg.rope_theta, sec)
    else:
        q = _attn_proj(x, p["wq"], cfg)
        k, v = cross_kv
        causal = False

    scale = hd ** -0.5
    chunk = min(cfg.attn_chunk, s_len) if cfg.attn_chunk else s_len
    if s_len % chunk:
        chunk = s_len          # irregular lengths: single pass
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

    qpos_all = positions[0] if positions.ndim == 2 else positions[0, 0]
    o = torch.cat([attend_chunk(q[:, c0:c0 + chunk], qpos_all[c0:c0 + chunk])
                   for c0 in range(0, s_len, chunk)], dim=1)
    out = _out_proj(o, p["wo"], cfg)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode attention: one new token against the KV cache.
# ---------------------------------------------------------------------------


def decode_mask(pos, s_len: int, window: int = 0,
                device=None) -> torch.Tensor:
    """Valid-slot mask (B or 1, s_len) bool for one decode step at ``pos``
    (an int, or a (B,) tensor of positions).

    Full attention: slot i valid iff i <= pos.  Windowed ring buffer: slot
    i holds absolute position pos - ((pos - i) % window); only never-
    written slots (abs < 0) are masked."""
    if torch.is_tensor(pos):
        device = pos.device
        pos = pos.reshape(-1, 1)
    else:
        pos = int(pos)                  # a host int: no copy to the device
    slots = torch.arange(s_len, device=device)[None, :]
    if window:
        return pos - torch.remainder(pos - slots, window) >= 0
    return slots <= pos


def decode_attention(x: torch.Tensor, p: dict, cfg: ArchConfig, cache: dict,
                     pos: int, *, window: int = 0, cross: bool = False):
    """x (B, 1, d); cache {k, v} (B, S_max, Hkv, hd) (+ scales if radix),
    updated in place at ``pos`` (a ring buffer of ``window`` slots, written
    at ``pos % window``, when ``window`` > 0).  ``cross``: attend over a
    cross-attention cache (the encoder's float K/V, which stays float
    under ``radix_kv``), unmasked and not written.  Returns (out
    (B, 1, d), cache)."""
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
    s = _gqa_scores(q, k).to(torch.float32) * hd ** -0.5  # (B,H,1,S)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    o = _gqa_out(pr, v)                                    # (B,1,H,hd)
    return _out_proj(o, p["wo"], cfg), cache


# ---------------------------------------------------------------------------
# Channel mixing: dense FFN variants.
# ---------------------------------------------------------------------------


def ffn(x: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    """Dense FFN: gated (SwiGLU, GeGLU), or ungated (``gelu_mlp``,
    ``relu_sq``); ``jax.nn.gelu`` is the tanh approximation."""
    matmul = functools.partial(radix_lib.maybe_radix_matmul, cfg=cfg)
    if cfg.act in ("swiglu", "geglu"):
        g = matmul(x, p["w_gate"])
        u = matmul(x, p["w_up"])
        h = (F.silu(g) if cfg.act == "swiglu"
             else F.gelu(g, approximate="tanh")) * u
        return matmul(h, p["w_down"])
    if cfg.act == "gelu_mlp":
        return matmul(F.gelu(matmul(x, p["w_up"]), approximate="tanh"),
                      p["w_down"])
    if cfg.act == "relu_sq":
        return matmul(torch.square(F.relu(matmul(x, p["w_up"]))),
                      p["w_down"])
    raise ValueError(cfg.act)


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
                state: Optional[dict] = None, *, return_state: bool = False):
    """Griffin recurrent block: [linear -> conv -> RG-LRU] * gate -> out.

    r, i = sigmoid(W_a u), sigmoid(W_x u); a = a_max^r with
    log a_max = -8 softplus(lambda); h = a h_- + sqrt(1 - a^2) (i u).
    Prefill scans over S; decode (``state`` {"conv": (B, K-1, W),
    "h": (B, W)}, S == 1) is one step."""
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
    r = torch.sigmoid(uf @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(uf @ p["w_x"].to(torch.float32) + p["b_x"])
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
    return (y, new_state) if (state is not None or return_state) else y


# ---------------------------------------------------------------------------
# RWKV-6 'Finch' time mix (data-dependent decay) + channel mix.
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """The x_{t-1} stream.  ``prev`` (B, d) is the carry for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_chunk_scan(r, k, v, w, u, chunk: int):
    """Chunked linear recurrence (all (B, H, S, hd), decay w in (0, 1)):

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
    reference's ``lax.scan`` does.  Returns (o (B, H, S, hd), S_final)."""
    b, h, s_len, hd = r.shape
    if s_len % chunk:
        raise ValueError(f"S={s_len} is not a multiple of chunk={chunk}")
    n = s_len // chunk
    rs, ks, vs, ws = (t.reshape(b, h, n, chunk, hd) for t in (r, k, v, w))
    logw = torch.log(torch.clamp(ws.to(torch.float32), 1e-9, 1.0))
    cum = torch.cumsum(logw, dim=3)                          # inclusive L
    exc = cum - logw                                         # exclusive E
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device),
                     diagonal=-1)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        rf, kf, vf = (t[:, :, c].to(torch.float32) for t in (rs, ks, vs))
        lc, ec = cum[:, :, c], exc[:, :, c]
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


def rwkv6_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                state: Optional[dict] = None, *, chunk: int = 64,
                return_state: bool = False):
    """RWKV-6 'Finch' time mix: token shift, per-projection mu mixing,
    the low-rank data-dependent decay, the wkv recurrence, a per-head
    groupnorm and the silu(g) gate.  x (B, S, d).

    Decode (``state`` {"last_x": (B, d), "S": (B, H, hd, hd) float32},
    S == 1) runs one step of the recurrence."""
    b, s_len, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    prev = state["last_x"] if state is not None else None
    sx = _token_shift(x, prev) - x                           # (B,S,d)

    def mix(tag):
        return x + sx * p[f"mu_{tag}"].to(x.dtype)

    r = mix("r") @ p["w_r"]
    k = mix("k") @ p["w_k"]
    v = mix("v") @ p["w_v"]
    g = F.silu(mix("g") @ p["w_g"])
    # Finch decay: w = exp(-exp(w0 + lora)) in (0, 1), data-dependent; the
    # low-rank factors are float32, so the product runs in float32 (jnp
    # promotes a bf16 operand; torch's matmul takes one dtype)
    lora = (torch.tanh(mix("w").to(torch.float32) @ p["w_dec_a"])
            @ p["w_dec_b"])
    logit = p["w_dec0"].to(torch.float32) + lora.to(torch.float32)
    w = torch.exp(-torch.exp(torch.clamp(logit, -20.0, 6.0)))  # (B,S,d)

    def heads(t):
        return t.reshape(b, s_len, h, hd).permute(0, 2, 1, 3)  # (B,H,S,hd)

    u = p["u_bonus"].to(torch.float32)                       # (H, hd)
    if state is None:
        chunk = min(cfg.rwkv_chunk or chunk, s_len)
        if s_len % chunk:
            chunk = s_len
        o, s_fin = _rwkv_chunk_scan(heads(r), heads(k), heads(v), heads(w),
                                    u[None, :, None, :], chunk)
        new_state = ({"last_x": x[:, -1, :], "S": s_fin}
                     if return_state else None)
    else:
        o1, s1 = _rwkv_step(heads(r)[:, :, 0], heads(k)[:, :, 0],
                            heads(v)[:, :, 0], heads(w)[:, :, 0], u[None],
                            state["S"])
        o = o1[:, :, None, :]
        new_state = {"last_x": x[:, -1, :], "S": s1}

    o = o.permute(0, 2, 1, 3).reshape(b, s_len, h, hd)       # (B,S,H,hd)
    of = o.to(torch.float32)                                 # per-head norm
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    o = (of - mu) * torch.rsqrt(var + 1e-5) * p["gn_w"] + p["gn_b"]
    o = o.reshape(b, s_len, d).to(x.dtype) * g
    y = o @ p["w_o"]
    return (y, new_state) if (state is not None or return_state) else y


def rwkv6_channel_mix(x: torch.Tensor, p: dict,
                      state: Optional[dict] = None, *,
                      return_state: bool = False):
    """RWKV channel mix: a token-shifted squared-relu MLP with a
    receptance gate.  Decode carries {"last_x": (B, d)}."""
    prev = state["last_x"] if state is not None else None
    sx = _token_shift(x, prev) - x
    xk = x + sx * p["mu_ck"].to(x.dtype)
    xr = x + sx * p["mu_cr"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["w_ck"]))
    y = torch.sigmoid(xr @ p["w_cr"]) * (kk @ p["w_cv"])
    if state is not None or return_state:
        return y, {"last_x": x[:, -1, :]}
    return y
