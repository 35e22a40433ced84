"""Reference of a radix-T prefill through a dense GQA transformer (the
GLM4-9B configuration): the last true position's logits of each prompt.

The equations are the configuration's, as the port states them: token
embedding; per layer an RMSNorm (epsilon 1e-6), Q/K/V projections,
rotary embeddings over the whole head_dim (frequencies
``theta^(-i / (hd/2))``, the halves rotated), causal softmax attention of
``n_heads`` query heads over ``n_kv_heads`` K/V heads, the output
projection and the residual; an RMSNorm, a SwiGLU FFN whose three
products are radix products, and the residual; a final RMSNorm and a
radix output layer.  A radix product quantizes its weight to int8 with
one scale per output channel (``absmax / 127``) and each activation row
to ``2^T`` unsigned levels of ``(x / s + 1) / 2``, ``s`` the row's
absolute maximum; the integer product is exact and
``y = s_x s_w (2 / (2^T - 1) * (q_x @ q_w) - colsum(q_w))``.

Arithmetic is float32 with TF32 off, one layer's weights and one prompt
at a time.  Values are stored between steps in a given dtype, by default
the configuration's (bfloat16 rounds every stored value, as a bfloat16
deployment keeps its weights, activations, scores and probabilities).
Radix quantization to 2^4 levels turns any difference at a level's
boundary into a whole level: one layer of a bfloat16 program stored in
float32 here reads about as far from this reference as the control does,
while stored as the configuration does, the two differ by the order of
float32 sums alone.  :class:`Model` runs one layer from any input, so a
check can take each layer from the program's own input to it.

``precision="lower"`` is the control, every product one precision step
below the configuration's: the inputs of each product it computes in
bfloat16 (the Q/K/V and output projections, QK^T and PV) rounded to
float8 e4m3, one scale per row and per output channel (absmax / 448), and
the radix products' weights int4 (levels -7..7) in place of int8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import no_tf32

__all__ = ["Model", "prefill_logits"]

_FP8_MAX = 448.0
_EXACT_K = 4096         # 15 * 127 * 4096 < 2^24: a float32 chunk sums exactly
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Numerics:
    """Where values are rounded: ``store`` after every step that writes a
    tensor in the storage dtype, ``product`` on the inputs of a product
    the configuration computes in that dtype; ``weight_max`` is the
    radix products' largest weight level."""

    def __init__(self, dtype: str, precision: str):
        if precision not in ("config", "lower"):
            raise ValueError(f"precision must be 'config' or 'lower', got "
                             f"{precision!r}")
        self.dtype = _DTYPES[dtype]
        self.lower = precision == "lower"
        self.weight_max = 7 if self.lower else 127

    def store(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return x
        return x.to(self.dtype).to(torch.float32)

    def product(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if not self.lower:
            return x
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of stored values, its result stored."""
        return self.store(self.product(x, -1) @ self.product(w, 0))


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, nm: _Numerics):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return nm.store(x * torch.rsqrt(var + 1e-6) * w.to(torch.float32))


def _radix_weight(w: torch.Tensor, nm: _Numerics) -> tuple:
    """(K, N) weight -> (int8 levels as float32, per-channel scale, column
    sums); the scale and the division by it in the stored dtype."""
    w = w.to(torch.float32)
    top = nm.weight_max
    sw = nm.store(w.abs().amax(dim=0) / float(top)).clamp_min(1e-12)
    qw = torch.clamp(torch.round(nm.store(w / sw)), -top, top)
    return qw, sw, qw.sum(dim=0)


def _radix_product(x: torch.Tensor, wq: tuple, steps: int, nm: _Numerics):
    """(..., K) stored activations @ a :func:`_radix_weight` through the
    radix product, the result stored."""
    qw, sw, colsum = wq
    lvl = (1 << steps) - 1
    sx = x.abs().amax(dim=-1, keepdim=True) + 1e-9
    qx = torch.clamp(torch.round((x / sx + 1.0) * 0.5 * lvl), 0, lvl)
    lead, k = x.shape[:-1], x.shape[-1]
    qx = qx.reshape(-1, k)
    acc = torch.zeros((qx.shape[0], qw.shape[1]), dtype=torch.int64,
                      device=x.device)
    for k0 in range(0, k, _EXACT_K):
        part = qx[:, k0:k0 + _EXACT_K] @ qw[k0:k0 + _EXACT_K]
        acc += torch.round(part).to(torch.int64)
    y = (2.0 / lvl) * acc.to(torch.float32) - colsum
    return nm.store((y.reshape(lead + (qw.shape[1],)) * sx) * sw)


def _rope(x: torch.Tensor, theta: float, nm: _Numerics) -> torch.Tensor:
    """Rotate (L, H, hd) by positions 0..L-1: float32 angles, cos and sin
    stored, each product and sum stored."""
    n, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    expo = -torch.arange(half, **f32) / torch.tensor(float(half), **f32)
    freq = torch.pow(torch.tensor(theta, **f32), expo)
    ang = torch.arange(n, **f32)[:, None] * freq
    cos = nm.store(torch.cos(ang))[:, None, :]
    sin = nm.store(torch.sin(ang))[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([nm.store(nm.store(x1 * cos) - nm.store(x2 * sin)),
                      nm.store(nm.store(x2 * cos) + nm.store(x1 * sin))],
                     dim=-1)


def _attention(q, k, v, nm: _Numerics) -> torch.Tensor:
    """Causal GQA attention of one prompt: q (L, H, hd), k/v (L, Hkv, hd)
    -> (L, H, hd); scores stored, then scaled and softmaxed in float32,
    the probabilities stored."""
    n, h, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for j in range(hkv):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)          # (g, L, hd)
        s = nm.matmul(qj, k[:, j].T) * (hd ** -0.5)
        s = torch.where(mask, s, -1e30)
        p = nm.store(torch.softmax(s, dim=-1))
        out[:, j * g:(j + 1) * g] = nm.matmul(p, v[:, j]).transpose(0, 1)
    return out


class Model:
    """The reference over one weight tree: :meth:`embed`, one layer
    (:meth:`layer`) from any input, and the head (:meth:`head`).

    ``params`` is the float weight tree the program was given: ``embed``
    (V, d), ``segments[0][0]`` with the layers' stacked ``ln1``, ``ln2``,
    ``mix`` (wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d)) and
    ``ffn`` (w_gate, w_up (d, f), w_down (f, d)), ``final_norm`` and
    ``unembed`` (d, V).  ``storage`` is the dtype values are stored in
    between steps (the configuration's, or "float32" for a plain float32
    forward); ``precision`` "lower" makes the control."""

    def __init__(self, cfg: dict, params: dict, storage: str,
                 precision: str = "config"):
        self.cfg, self.params = cfg, params
        self.nm = _Numerics(storage, precision)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens].to(torch.float32)

    def _weights(self, i: int) -> dict:
        cfg = self.cfg
        d, h, hkv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                         cfg["head_dim"])
        mix = self.params["segments"][0][0]["mix"]
        return {k: mix[k][i].to(torch.float32).reshape(shape)
                for k, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                                 ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}

    def attention(self, i: int, hs: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s attention block over (B, L, d) inputs: its
        (B, L, d) output before the residual."""
        cfg, nm = self.cfg, self.nm
        h, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        ln = self.params["segments"][0][0]["ln1"]["w"][i]
        theta = cfg["rope_theta"]
        n = hs.shape[1]
        out = torch.empty_like(hs)
        with torch.no_grad(), no_tf32():
            w = self._weights(i)
            for r in range(hs.shape[0]):
                xn = _rmsnorm(nm.store(hs[r]), ln, nm)
                q = _rope(nm.matmul(xn, w["wq"]).reshape(n, h, hd), theta,
                          nm)
                k = _rope(nm.matmul(xn, w["wk"]).reshape(n, hkv, hd), theta,
                          nm)
                v = nm.matmul(xn, w["wv"]).reshape(n, hkv, hd)
                o = _attention(q, k, v, nm).reshape(n, h * hd)
                out[r] = nm.matmul(o, w["wo"])
        return out

    def ffn(self, i: int, hs: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s FFN block over (B, L, d) inputs (the residual
        stream after attention): its output before the residual."""
        nm, steps = self.nm, self.cfg["radix_steps"]
        lp = self.params["segments"][0][0]
        out = torch.empty_like(hs)
        with torch.no_grad(), no_tf32():
            rw = {k: _radix_weight(lp["ffn"][k][i], nm)
                  for k in ("w_gate", "w_up", "w_down")}
            for r in range(hs.shape[0]):
                xn = _rmsnorm(nm.store(hs[r]), lp["ln2"]["w"][i], nm)
                gate = _radix_product(xn, rw["w_gate"], steps, nm)
                up = _radix_product(xn, rw["w_up"], steps, nm)
                act = nm.store(nm.store(F.silu(gate)) * up)
                out[r] = _radix_product(act, rw["w_down"], steps, nm)
        return out

    def layer(self, i: int, hs: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` over (B, L, d) inputs -> (B, L, d) outputs."""
        nm = self.nm
        mid = nm.store(nm.store(hs) + self.attention(i, hs))
        return nm.store(mid + self.ffn(i, mid))

    def head(self, last: torch.Tensor) -> torch.Tensor:
        """(B, d) last true positions -> (B, vocab) logits."""
        with torch.no_grad(), no_tf32():
            x = _rmsnorm(self.nm.store(last), self.params["final_norm"]["w"],
                         self.nm)
            return _radix_product(
                x, _radix_weight(self.params["unembed"], self.nm),
                self.cfg["radix_steps"], self.nm)


def prefill_logits(cfg: dict, params: dict, tokens: torch.Tensor,
                   precision: str = "config") -> torch.Tensor:
    """(B, L) token ids -> (B, vocab) float32 logits of position L - 1,
    every layer from the one before, values stored in the configuration's
    dtype."""
    m = Model(cfg, params, cfg["dtype"], precision)
    hs = m.embed(tokens)
    for i in range(cfg["n_layers"]):
        hs = m.layer(i, hs)
    return m.head(hs[:, -1])
