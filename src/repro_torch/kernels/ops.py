"""Public wrappers around the radix kernels (port of ``repro/kernels/ops.py``).

Handles what the raw kernels omit: SAME pre-padding, strides, bias, the
``(1, N)`` epilogue rows, the GEMMs' plane-occupancy prepass
(``sparsity=True``: one pass finds the bit planes no activation spikes
on, and the kernels skip (bitserial) or mask (fused) them, bit-exactly)
and the encoder's reshape.  Decode attention needs none of it: its
kernel takes the caller's tensors as they are.

The CUDA kernels mask their own ragged edges, so unlike the reference
nothing is padded to block multiples.  The reference's XLA twins
``_xla_matmul``/``_xla_conv2d``/``_xla_decode_attn`` are the kernels'
plain versions (``radix_matmul_plain``, ``radix_conv2d_plain``,
``radix_decode_attn_plain``), which ``config=KernelConfig(impl="plain")``
pins.  ``autotune=True`` times the launches ``kernels.autotune`` offers
for the call's problem and reuses the cached winner on repeat shapes;
``config=`` pins one launch.  Every GEMM launch gives the same integers;
an attention launch's KV split sets its float order, which the plain
version repeats when it is given the same split.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.encoding import EncodingSpec, KernelSchedule
from repro_torch.core.layers import same_pads
from repro_torch.kernels import autotune as autotune_mod
from repro_torch.kernels import gemm, radix_attn
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.radix_attn import Q_BITS
from repro_torch.kernels.radix_conv import (radix_conv2d_cuda,
                                            radix_conv2d_plain)
from repro_torch.kernels.radix_matmul import (plane_occupancy,
                                               radix_matmul_cuda,
                                               radix_matmul_plain)
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


def _schedule(num_steps: Union[int, EncodingSpec]) -> KernelSchedule:
    """A bare T (plain radix schedule) or a kernels-capable spec's
    :class:`KernelSchedule`."""
    if isinstance(num_steps, EncodingSpec):
        num_steps.validate_dataflow(None)
        return num_steps.kernel_schedule()
    return KernelSchedule(packed_bits=int(num_steps))


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


def _resolve_config(config: Optional[KernelConfig], autotune: bool,
                   key_fn: Callable[[], tuple],
                   cand_fn: Callable[[], list],
                   build_fn: Callable) -> KernelConfig:
    """One call's launch: an explicit ``config``; else, with ``autotune``,
    the tuned winner (swept on a miss); else the untuned default.  With
    ``autotune``, ``config=KernelConfig(impl="plain")`` takes the winner's
    launch parameters, so a plain path repeats the tuned launch."""
    if not autotune:
        return config if config is not None else KernelConfig()
    if config is not None and config.impl != "plain":
        return config
    win = autotune_mod.tune(key_fn(), cand_fn(), build_fn)
    return win if config is None else dataclasses.replace(win, impl="plain")


def _matmul_with_config(cfg: KernelConfig, x2, w_q, b_int, mult, sched,
                        spec, method, sparsity, kmajor):
    """One matmul launch (or the plain version) on (M, K) levels."""
    n = w_q.shape[0 if kmajor else -1]
    occ = plane_occupancy(x2, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method,
              periods=sched.periods, occupancy=occ, kmajor=kmajor)
    if cfg.impl == "cuda":
        fn, kw["config"] = radix_matmul_cuda, cfg
    else:
        fn = radix_matmul_plain
    if mult is None:
        out = fn(x2, w_q, **kw)
        return out if b_int is None else out + b_int.to(out.device)
    bias_row, mult_row = epilogue_rows(b_int, mult, n, n, encoding=spec,
                                       device=x2.device)
    return fn(x2, w_q, bias=bias_row, mult=mult_row,
              out_level=sched.out_level, out_grid=sched.out_grid, **kw)


def radix_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *,
                 method: str = "bitserial", mult=None,
                 sparsity: bool = False, autotune: bool = False,
                 config: Optional[KernelConfig] = None,
                 kmajor: bool = False) -> torch.Tensor:
    """(..., K) packed levels @ (K, N) int8 (+bias) -> (..., N).

    ``mult=None``: raw int32 accumulator (+bias outside the kernel);
    ``mult`` given: the fused epilogue, packed uint8 levels.  ``num_steps``
    may be a bare T or a kernels-capable spec.  ``sparsity=True`` runs
    the plane-occupancy prepass.  ``kmajor``: ``w_q`` is the (N, K) layout
    the kernel reads (``gemm.matmul_kmajor``); (K, N) weights on CUDA are
    copied K-major per call.  ``autotune``/``config`` as in the module
    note."""
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    lead = tuple(x_q.shape[:-1])
    k = x_q.shape[-1]
    n = w_q.shape[0 if kmajor else -1]
    x2 = x_q.reshape(-1, k).contiguous()
    m = x2.shape[0]

    def run(c):
        return _matmul_with_config(c, x2, w_q, b_int, mult, sched, spec,
                                   method, sparsity, kmajor)

    cfg = _resolve_config(
        config, autotune,
        key_fn=lambda: autotune_mod.matmul_key(
            m, k, n, sched, method, epilogue=mult is not None,
            sparsity=sparsity, backend=x2.device),
        cand_fn=lambda: autotune_mod.matmul_candidates(
            m, k, n, sched, method, backend=x2.device,
            sms=gemm.device_sms(x2.device)),
        build_fn=lambda c: (lambda: run(c)))
    return run(cfg).reshape(*lead, n)


def _conv_with_config(cfg: KernelConfig, x_q, w_q, b_int, mult, sched, spec,
                      method, stride, sparsity, kmajor):
    """One conv launch (or the plain version) on pre-padded NHWC levels."""
    cout = w_q.shape[0 if kmajor else -1]
    occ = plane_occupancy(x_q, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method, stride=stride,
              periods=sched.periods, occupancy=occ, kmajor=kmajor)
    if cfg.impl == "cuda":
        fn, kw["config"] = radix_conv2d_cuda, cfg
    else:
        fn = radix_conv2d_plain
    if mult is None:
        out = fn(x_q, w_q, **kw)
        return out if b_int is None else out + b_int.to(out.device)
    bias_row, mult_row = epilogue_rows(b_int, mult, cout, cout,
                                       encoding=spec, device=x_q.device)
    return fn(x_q, w_q, bias=bias_row, mult=mult_row,
              out_level=sched.out_level, out_grid=sched.out_grid, **kw)


def radix_conv2d(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *, stride: int = 1,
                 padding: str = "VALID", method: str = "bitserial",
                 mult=None, sparsity: bool = False, autotune: bool = False,
                 config: Optional[KernelConfig] = None,
                 kmajor: bool = False) -> torch.Tensor:
    """NHWC packed levels * HWIO int8 -> NHWC conv (+bias).

    SAME is pre-padded here (XLA-exact pads for any stride); the stride
    subsamples in-kernel.  ``mult``, ``sparsity``, ``num_steps``,
    ``autotune`` and ``config`` as in :func:`radix_matmul`; ``kmajor``:
    ``w_q`` is the (Cout, KH, KW, Cin) layout the kernel reads
    (``gemm.conv_kmajor``)."""
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    if kmajor:
        cout, kh, kw_, cin = w_q.shape
    else:
        kh, kw_, cin, cout = w_q.shape
    if padding == "SAME":
        ph = same_pads(x_q.shape[1], kh, stride)
        pw = same_pads(x_q.shape[2], kw_, stride)
        x_q = F.pad(x_q, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(padding)
    x_q = x_q.contiguous()
    batch, h, w = x_q.shape[:3]

    def run(c):
        return _conv_with_config(c, x_q, w_q, b_int, mult, sched, spec,
                                 method, stride, sparsity, kmajor)

    cfg = _resolve_config(
        config, autotune,
        key_fn=lambda: autotune_mod.conv_key(
            h, w, cin, kh, kw_, cout, stride, sched, method, batch=batch,
            epilogue=mult is not None, sparsity=sparsity,
            backend=x_q.device),
        cand_fn=lambda: autotune_mod.conv_candidates(
            h, w, cin, kh, kw_, cout, stride, sched, method, batch=batch,
            backend=x_q.device, sms=gemm.device_sms(x_q.device)),
        build_fn=lambda c: (lambda: run(c)))
    return run(cfg)


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
    validity.  Returns (B, H, hd) f32 (pre out-projection).  Everything
    goes to the kernel as the caller holds it (``config.impl ==
    "plain"``: to its plain version): the kernel quantizes the query
    (``q_bits``), reads the cache and the mask through their strides and
    gates its plane passes on each tile's own occupancy (``sparsity``),
    so on the card one call is one launch.  ``autotune`` tunes the KV
    split (``config.split_slots``/``max_splits``) per
    ``autotune.attn_key``; ``config=`` pins one."""
    b, h, hd = q.shape
    s_len, hkv = k_q.shape[1], k_q.shape[2]

    def run(c):
        fn = (radix_attn.radix_decode_attn_cuda if c.impl == "cuda"
              else radix_attn.radix_decode_attn_plain)
        return fn(q, k_q, k_scale, v_q, v_scale, mask, num_steps=num_steps,
                  q_bits=q_bits, method=method, packed=packed,
                  sparsity=sparsity, splits=c.splits)

    cfg = _resolve_config(
        config, autotune,
        key_fn=lambda: autotune_mod.attn_key(
            b, s_len, hkv, h // max(hkv, 1), hd, num_steps, method,
            q_bits=q_bits, packed=packed, sparsity=sparsity,
            backend=q.device),
        cand_fn=lambda: autotune_mod.attn_candidates(s_len,
                                                     backend=q.device),
        build_fn=lambda c: (lambda: run(c)))
    return run(cfg)


def radix_encode(x: torch.Tensor, num_steps: Union[int, EncodingSpec],
                 scale: float = 1.0) -> torch.Tensor:
    """float -> packed radix levels (uint8), any shape: the spike encoder
    kernel over the elements in memory order (float32; other float types
    are widened first)."""
    steps = _schedule(num_steps).packed_bits
    x = x.to(torch.float32).contiguous()
    return spike_encode_cuda(x, num_steps=steps, scale=float(scale))
