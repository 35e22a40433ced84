"""Plain oracles for the radix kernels (port of ``repro/kernels/ref.py``).

Each oracle spells out the radix bit-serial math plane by plane, so the
kernels and their plain versions are checked against a second
derivation.  All integer accumulators are int32; products go through the
exact float64 primitives of ``core.layers``.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import pow2_floor
from repro_torch.core.layers import _int_conv, _int_matmul

__all__ = [
    "radix_matmul_ref",
    "radix_conv2d_ref",
    "requantize_ref",
    "radix_matmul_epilogue_ref",
    "radix_conv2d_epilogue_ref",
    "decode_mask_ref",
    "decode_attn_ref",
]


def _bitserial(x_q: torch.Tensor, op, num_steps: int, periods: int):
    """``sum_t 2^(T-1-t) op(plane_t)`` (Horner), or the phase schedule
    (``periods * T`` passes with weights ``2^(T-1-(t mod T))``, then
    ``// periods``)."""
    x = x_q.to(torch.int32)
    acc = None
    if periods == 1:
        for t in range(num_steps):
            part = op((x >> (num_steps - 1 - t)) & 1)
            acc = part if acc is None else (acc << 1) + part
        return acc
    for t in range(num_steps * periods):
        shift = num_steps - 1 - (t % num_steps)
        part = op((x >> shift) & 1) << shift
        acc = part if acc is None else acc + part
    return torch.div(acc, periods, rounding_mode="floor")


def radix_matmul_ref(x_q, w_q, num_steps: int, *, periods: int = 1):
    """Bit-serial matmul oracle: (M, K) levels x (K, N) int8 -> int32."""
    return _bitserial(x_q, lambda p: _int_matmul(p, w_q), num_steps, periods)


def radix_conv2d_ref(x_q, w_q, num_steps: int, *, stride: int = 1,
                     periods: int = 1):
    """Bit-serial strided VALID conv oracle (NHWC x HWIO -> NHWC int32)."""
    return _bitserial(x_q, lambda p: _int_conv(p, w_q, stride, "VALID"),
                      num_steps, periods)


def requantize_ref(acc, num_steps: int, mult, *, grid: str = "dense"):
    """Output logic: ``clip(floor(f32(acc) * mult), 0, 2^T - 1)``, then
    ``pow2_floor`` for ``grid="pow2"``; uint8 out."""
    lvl = (1 << num_steps) - 1
    mult = torch.as_tensor(mult, dtype=torch.float32, device=acc.device)
    q = torch.floor(acc.to(torch.float32) * mult)
    q = torch.clamp(q, 0, lvl).to(torch.int32)
    if grid == "pow2":
        q = pow2_floor(q, num_steps)
    elif grid != "dense":
        raise ValueError(grid)
    return q.to(torch.uint8)


def radix_matmul_epilogue_ref(x_q, w_q, bias, mult, num_steps: int, *,
                              periods: int = 1, grid: str = "dense"):
    """Bit-serial matmul + fused output logic -> packed uint8 levels."""
    acc = radix_matmul_ref(x_q, w_q, num_steps, periods=periods)
    return requantize_ref(acc + bias.to(torch.int32), num_steps, mult,
                          grid=grid)


def radix_conv2d_epilogue_ref(x_q, w_q, bias, mult, num_steps: int, *,
                              stride: int = 1, periods: int = 1,
                              grid: str = "dense"):
    """Bit-serial strided VALID conv + fused output logic -> uint8 levels."""
    acc = radix_conv2d_ref(x_q, w_q, num_steps, stride=stride,
                           periods=periods)
    return requantize_ref(acc + bias.to(torch.int32), num_steps, mult,
                          grid=grid)


# ---------------------------------------------------------------------------
# Decode-attention oracles (kernels/radix_attn.py), plane-level spelling.
# ---------------------------------------------------------------------------


def decode_mask_ref(pos: int, s_len: int, window: int = 0) -> torch.Tensor:
    """Valid-slot mask for one decode step, derived by simulation: replay
    every write the cache performed (token p lands in slot p % window, or
    p without a window) and mark the slots tokens 0..pos wrote."""
    valid = torch.zeros(s_len, dtype=torch.bool)
    for p in range(int(pos) + 1):
        valid[p % window if window else p] = True
    return valid


def decode_attn_ref(q, k_q, k_scale, v_q, v_scale, mask, num_steps: int, *,
                    q_bits: int = 7) -> torch.Tensor:
    """Plane-level decode-attention oracle.

    q (B, H, hd) float; k_q/v_q (B, S, Hkv, hd) uint8 levels (unpacked);
    scales (B, S, Hkv) f32; mask (B, S) bool -> (B, H, hd) f32.  The
    integer dot accumulates bit-serially over k's planes, masked slots
    score -inf before the max (their probability is exactly 0), and the
    PV sum runs plane by plane over v's levels in f32 with the dequant
    affine folded out through the probability row-sum."""
    b, h, hd = q.shape
    hkv = k_q.shape[2]
    g = h // hkv
    lvl = (1 << num_steps) - 1
    qlvl = (1 << q_bits) - 1

    qs = q.abs().amax(dim=-1, keepdim=True).to(torch.float32) + 1e-9
    qu = (q.to(torch.float32) / qs + 1.0) * 0.5
    qq = torch.clamp(torch.round(qu * qlvl), 0, qlvl).to(torch.int32)

    qg = qq.reshape(b, hkv, g, hd).to(torch.float64)
    kq = k_q.to(torch.int32)
    sint = torch.zeros((b, hkv, g, kq.shape[1]), dtype=torch.int32,
                       device=q.device)
    for t in range(num_steps):                           # bit-serial QK^T
        plane = ((kq >> t) & 1).to(torch.float64)
        sint = sint + (torch.einsum("bhgd,bshd->bhgs", qg, plane).to(
            torch.int32) << t)

    qsum = qg.sum(dim=-1, keepdim=True).to(torch.float32)
    ksum = kq.sum(dim=-1).to(torch.float32)              # (B, S, Hkv)
    raw = (4.0 / (qlvl * lvl)) * sint.to(torch.float32) \
        - (2.0 / qlvl) * qsum \
        - (2.0 / lvl) * ksum.movedim(1, 2)[:, :, None, :] + float(hd)
    qsg = qs.reshape(b, hkv, g)[..., None]
    skg = k_scale.movedim(1, 2)[:, :, None, :]           # (B, Hkv, 1, S)
    scores = (hd ** -0.5) * qsg * skg * raw              # (B, Hkv, g, S)

    valid = mask[:, None, None, :]
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0.0, l, torch.ones_like(l))

    pw = p * v_scale.movedim(1, 2)[:, :, None, :]        # fold v scales
    vq = v_q.to(torch.int32)
    vint = torch.zeros((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    for t in range(num_steps):                           # bit-serial PV
        plane = ((vq >> t) & 1).to(torch.float32)
        vint = vint + torch.einsum("bhgs,bshd->bhgd", pw, plane) * float(1 << t)
    out = (2.0 / lvl) * vint - pw.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, hd)
