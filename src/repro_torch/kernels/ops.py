"""Public wrappers around the radix kernels (port of ``repro/kernels/ops.py``).

Handles what the raw kernels omit: SAME pre-padding, strides, bias, the
``(1, N)`` epilogue rows, the plane-occupancy prepass (``sparsity=True``:
one pass finds the bit planes no activation spikes on, and the kernels
skip (bitserial) or mask (fused) them, bit-exactly), the decode query's
quantization and ``(N = B*Hkv)`` row layout, and the encoder's reshape.

The CUDA kernels mask their own ragged edges, so unlike the reference
nothing is padded to block multiples.  The reference's XLA twins
``_xla_matmul``/``_xla_conv2d``/``_xla_decode_attn`` are the kernels'
plain versions (``radix_matmul_plain``, ``radix_conv2d_plain``,
``radix_decode_attn_plain``).  Autotuning comes with a later slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.encoding import EncodingSpec, KernelSchedule
from repro_torch.core.layers import same_pads
from repro_torch.kernels import radix_attn
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.radix_attn import Q_BITS
from repro_torch.kernels.radix_conv import radix_conv2d_cuda
from repro_torch.kernels.radix_matmul import OCC_LANES, radix_matmul_cuda
from repro_torch.kernels.spike_encode import spike_encode_cuda

__all__ = [
    "KernelConfig",
    "Q_BITS",
    "radix_matmul",
    "radix_conv2d",
    "radix_decode_attention",
    "radix_encode",
    "epilogue_rows",
    "plane_occupancy",
    "same_pads",
]

_AUTOTUNE_LATER = ("autotune=True is not ported yet: the Hopper tuner comes "
                   "with ROADMAP.md queue 1 item 10")


def _schedule(num_steps: Union[int, EncodingSpec]) -> KernelSchedule:
    """A bare T (plain radix schedule) or a kernels-capable spec's
    :class:`KernelSchedule`."""
    if isinstance(num_steps, EncodingSpec):
        num_steps.validate_dataflow(None)
        return num_steps.kernel_schedule()
    return KernelSchedule(packed_bits=int(num_steps))


def plane_occupancy(x_q: torch.Tensor,
                    num_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bit-plane occupancy of packed levels.

    Returns ``(row, bits)`` on ``x_q``'s device: ``row`` the ``(1,
    OCC_LANES)`` int32 input the kernels read (entry ``[0, s]`` gates the
    shift-``s`` plane), ``bits`` the ``(num_bits,)`` 0/1 int32 vector.
    PyTorch has no bitwise-OR reduction, so each plane is an ``any`` over
    its bit; nothing syncs with the host.
    """
    bits = torch.stack([((x_q >> s) & 1).any() for s in range(num_bits)])
    bits = bits.to(torch.int32)
    row = torch.zeros((1, OCC_LANES), dtype=torch.int32, device=x_q.device)
    row[0, :num_bits] = bits
    return row, bits


def epilogue_rows(b_int: Optional[torch.Tensor], mult, n: int, n_pad: int,
                  *, encoding: Optional[EncodingSpec] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold (bias, requant multiplier) into ``(1, n_pad)`` epilogue rows;
    padding lanes get ``mult = 0`` (level 0)."""
    if encoding is not None:
        _schedule(encoding)
    if device is None:
        device = mult.device if torch.is_tensor(mult) else "cpu"
    bias = torch.zeros(n, dtype=torch.int32, device=device) if b_int is None \
        else b_int.to(device=device, dtype=torch.int32).reshape(n)
    mrow = torch.as_tensor(mult, dtype=torch.float32, device=device)
    mrow = torch.broadcast_to(mrow.reshape(-1), (n,))
    bias = F.pad(bias, (0, n_pad - n)).reshape(1, n_pad)
    mrow = F.pad(mrow, (0, n_pad - n)).reshape(1, n_pad)
    return bias.contiguous(), mrow.contiguous()


def radix_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *,
                 method: str = "bitserial", mult=None,
                 sparsity: bool = False, autotune: bool = False,
                 kmajor: bool = False) -> torch.Tensor:
    """(..., K) packed levels @ (K, N) int8 (+bias) -> (..., N).

    ``mult=None``: raw int32 accumulator (+bias outside the kernel);
    ``mult`` given: the fused epilogue, packed uint8 levels.  ``num_steps``
    may be a bare T or a kernels-capable spec.  ``sparsity=True`` runs
    the plane-occupancy prepass.  ``kmajor``: ``w_q`` is the (N, K) layout
    the kernel reads (``gemm.matmul_kmajor``); (K, N) weights on CUDA are
    copied K-major per call."""
    if autotune:
        raise NotImplementedError(_AUTOTUNE_LATER)
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    lead = tuple(x_q.shape[:-1])
    k = x_q.shape[-1]
    n = w_q.shape[0 if kmajor else -1]
    x2 = x_q.reshape(-1, k).contiguous()
    occ = plane_occupancy(x2, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method,
              periods=sched.periods, occupancy=occ, kmajor=kmajor)
    if mult is None:
        out = radix_matmul_cuda(x2, w_q, **kw)
        if b_int is not None:
            out = out + b_int.to(out.device)
    else:
        bias_row, mult_row = epilogue_rows(b_int, mult, n, n, encoding=spec,
                                           device=x_q.device)
        out = radix_matmul_cuda(x2, w_q, bias=bias_row, mult=mult_row,
                                out_level=sched.out_level,
                                out_grid=sched.out_grid, **kw)
    return out.reshape(*lead, n)


def radix_conv2d(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *, stride: int = 1,
                 padding: str = "VALID", method: str = "bitserial",
                 mult=None, sparsity: bool = False, autotune: bool = False,
                 kmajor: bool = False) -> torch.Tensor:
    """NHWC packed levels * HWIO int8 -> NHWC conv (+bias).

    SAME is pre-padded here (XLA-exact pads for any stride); the stride
    subsamples in-kernel.  ``mult``, ``sparsity`` and ``num_steps`` as in
    :func:`radix_matmul`; ``kmajor``: ``w_q`` is the (Cout, KH, KW, Cin)
    layout the kernel reads (``gemm.conv_kmajor``)."""
    if autotune:
        raise NotImplementedError(_AUTOTUNE_LATER)
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    if kmajor:
        cout, kh, kw_, _ = w_q.shape
    else:
        kh, kw_, _, cout = w_q.shape
    if padding == "SAME":
        ph = same_pads(x_q.shape[1], kh, stride)
        pw = same_pads(x_q.shape[2], kw_, stride)
        x_q = F.pad(x_q, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(padding)
    x_q = x_q.contiguous()
    occ = plane_occupancy(x_q, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method, stride=stride,
              periods=sched.periods, occupancy=occ, kmajor=kmajor)
    if mult is None:
        out = radix_conv2d_cuda(x_q, w_q, **kw)
        return out if b_int is None else out + b_int.to(out.device)
    bias_row, mult_row = epilogue_rows(b_int, mult, cout, cout,
                                       encoding=spec, device=x_q.device)
    return radix_conv2d_cuda(x_q, w_q, bias=bias_row, mult=mult_row,
                             out_level=sched.out_level,
                             out_grid=sched.out_grid, **kw)


def _nibble_union(levels: torch.Tensor) -> torch.Tensor:
    """Per-byte OR of hi/lo nibbles: the occupancy view of a packed cache
    (its planes' union equals the unpacked levels')."""
    return (levels >> 4) | (levels & 0xF)


def radix_decode_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    mask: torch.Tensor,
    num_steps: int,
    *,
    packed: bool = False,
    method: str = "bitserial",
    q_bits: int = Q_BITS,
    sparsity: bool = True,
    autotune: bool = False,
    config: Optional[KernelConfig] = None,
) -> torch.Tensor:
    """One decode step of attention directly over the radix KV cache.

    ``q`` (B, H, hd) float decode queries (post-RoPE); ``k_q``/``v_q``
    (B, S, Hkv, hd) uint8 levels, or (B, S, Hkv, hd // 2) when ``packed``;
    ``k_scale``/``v_scale`` (B, S, Hkv) f32; ``mask`` (B, S) boolean slot
    validity.  Returns (B, H, hd) f32 (pre out-projection).  The query is
    radix-quantized here (``q_bits``), laid out as ``N = B * Hkv`` rows of
    ``g = H / Hkv`` heads, and handed with the cache to the kernel
    (``config.impl == "plain"``: its plain version).  ``sparsity`` runs
    the plane-occupancy prepass over the cache (over ``_nibble_union``
    when packed)."""
    if autotune:
        raise NotImplementedError(_AUTOTUNE_LATER)
    b, h, hd = q.shape
    s_len, hkv = k_q.shape[1], k_q.shape[2]
    g = h // hkv
    if g * hkv != h:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    n = b * hkv
    qq, qscale = radix_attn.quantize_q(q, q_bits)
    qq = qq.reshape(n, g, hd)
    qs = qscale.reshape(n, g)

    def seq_major(a):                     # (B, S, Hkv, ...) -> (N, S, ...)
        moved = a.movedim(2, 1)
        return moved.reshape((n,) + tuple(moved.shape[2:])).contiguous()

    maskn = mask.reshape(b, 1, s_len).expand(b, hkv, s_len)
    maskn = maskn.reshape(n, s_len).to(torch.int32).contiguous()
    if sparsity:
        occ_k = plane_occupancy(_nibble_union(k_q) if packed else k_q,
                                num_steps)[0]
        occ_v = plane_occupancy(_nibble_union(v_q) if packed else v_q,
                                num_steps)[0]
    else:
        occ_k = occ_v = torch.ones((1, OCC_LANES), dtype=torch.int32,
                                   device=q.device)
    impl = "cuda" if config is None else config.impl
    fn = (radix_attn.radix_decode_attn_cuda if impl == "cuda"
          else radix_attn.radix_decode_attn_plain)
    out = fn(qq, qs, seq_major(k_q), seq_major(k_scale), seq_major(v_q),
             seq_major(v_scale), maskn, occ_k, occ_v, num_steps=num_steps,
             q_bits=q_bits, hd=hd, method=method, packed=packed,
             sparsity=sparsity)
    return out.reshape(b, h, hd)


def radix_encode(x: torch.Tensor, num_steps: Union[int, EncodingSpec],
                 scale: float = 1.0) -> torch.Tensor:
    """float -> packed radix levels (uint8), any shape: the spike encoder
    kernel over the elements in memory order (float32; other float types
    are widened first)."""
    steps = _schedule(num_steps).packed_bits
    x = x.to(torch.float32).contiguous()
    return spike_encode_cuda(x, num_steps=steps, scale=float(scale))
