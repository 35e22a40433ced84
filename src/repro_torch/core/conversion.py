"""ANN -> SNN conversion (port of ``repro/core/conversion.py``).

Pipeline: calibrate per-layer activation scales on a calibration batch,
quantize weights to ``weight_bits`` symmetric signed integers, fold the
scales into per-layer requantization multipliers.

A network is ``(static, params)``: ``static`` a tuple of ``(kind, cfg)``
pairs (kind in conv/linear/pool/flatten), ``params`` one entry per layer,
``{"w", "b"}`` float32 tensors for conv/linear (HWIO / (F, G)) and
``None`` otherwise.  Tensors may live on any device; the converted net's
tensors live on the device of the params.

Float op order follows the reference: every division by a scale divides
by a float32 tensor on the operand's device (CUDA lowers division by a
host scalar to a reciprocal multiply), and the percentile is the
reference's float32 linear interpolation over a full sort
(``torch.quantile`` refuses inputs over 2^24 elements, and VGG-11's first
activation at 224 x 224, batch 8, has 25.7 M).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import layers
from repro_torch.core.encoding import EncodingSpec, RadixEncoding

__all__ = [
    "float_forward",
    "calibrate",
    "quantize_weights",
    "convert",
    "QuantizedNet",
]

Static = Tuple[Tuple[str, dict], ...]


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` with ``b`` as a float32 tensor on ``a``'s device."""
    return a / torch.as_tensor(b, dtype=torch.float32, device=a.device)


def float_forward(static: Static, params: Sequence[Optional[dict]],
                  x: torch.Tensor, *, return_activations: bool = False):
    """Float ANN forward, NHWC.  ReLU after every conv/linear except the
    last; "or" pools train as max (their float surrogate)."""
    acts = []
    n_affine = sum(1 for k, _ in static if k in ("conv", "linear"))
    seen_affine = 0
    for (kind, cfg), p in zip(static, params):
        if kind == "conv":
            seen_affine += 1
            stride = cfg.get("stride", 1)
            w = p["w"].to(x.device)
            if cfg.get("padding", "VALID") == "SAME":
                ph = layers.same_pads(x.shape[1], w.shape[0], stride)
                pw = layers.same_pads(x.shape[2], w.shape[1], stride)
                x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
            x = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         stride=stride).permute(0, 2, 3, 1)
            x = x + p["b"].to(x.device)
            if seen_affine < n_affine:
                x = torch.relu(x)
                acts.append(x)
        elif kind == "linear":
            seen_affine += 1
            x = x @ p["w"].to(x.device) + p["b"].to(x.device)
            if seen_affine < n_affine:
                x = torch.relu(x)
                acts.append(x)
        elif kind == "pool":
            win = layers._windows(x, cfg["window"])
            if cfg.get("mode", "or") == "avg":
                x = _div(win.sum(dim=(2, 4)), float(cfg["window"] ** 2))
            else:
                x = win.amax(dim=(2, 4))
        elif kind == "flatten":
            x = x.reshape(x.shape[0], -1)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    if return_activations:
        return x, acts
    return x


def _percentile(a: torch.Tensor, percentile: float) -> float:
    """The reference's float32 linear-interpolation percentile, over a sort.

    XLA compiles the reference's arithmetic as the position
    ``percentile * (0.01 * (n - 1))`` (``n`` is a compile-time constant)
    and the interpolation as ``fma(hi, w_hi, lo * w_lo)``, all float32;
    this repeats those steps, the fused multiply-add as one float64 sum
    (the float32 product is exact there) rounded once to float32."""
    s = torch.sort(a.reshape(-1)).values
    n = s.numel()
    f32 = dict(dtype=torch.float32)
    last = torch.tensor(float(n), **f32) - 1
    q = torch.tensor(percentile, **f32) * (
        (torch.tensor(1.0, **f32) / torch.tensor(100.0, **f32)) * last)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    lo_v, hi_v = s[[lo_i, hi_i]].cpu()
    fused = hi_v.double() * high_w.double() + (lo_v * low_w).double()
    return float(fused.float())


def calibrate(static: Static, params, calib_x: torch.Tensor,
              percentile: float = 99.9) -> List[float]:
    """Per-requant-point activation scales: ``scales[0]`` the input scale,
    ``scales[i]`` the scale of the activation feeding affine layer ``i``."""
    with torch.no_grad():
        _, acts = float_forward(static, params, calib_x,
                                return_activations=True)
        scales = [float(max(1.0, float(calib_x.max())))]
        for a in acts:
            if percentile >= 100.0:
                s = float(a.max())
            else:
                s = _percentile(a, percentile)
            scales.append(max(s, 1e-6))
    return scales


def quantize_weights(w: torch.Tensor, weight_bits: int,
                     per_channel: bool = False):
    """Symmetric quantization to ``weight_bits`` signed levels (3 bits ->
    [-3, 3]); ``per_channel`` uses one scale per output channel."""
    qmax = 2 ** (weight_bits - 1) - 1
    if per_channel:
        s_w = _div(w.abs().amax(dim=tuple(range(w.ndim - 1))), float(qmax))
        s_w = torch.clamp_min(s_w, 1e-12)
    else:
        s_w = max(float(w.abs().max()) / qmax if qmax > 0 else 1.0, 1e-12)
    w_q = torch.clamp(torch.round(_div(w, s_w)), -qmax, qmax).to(torch.int8)
    return w_q, s_w


@dataclasses.dataclass(eq=False)
class QuantizedNet:
    """Converted network: integer weights + folded requant multipliers.

    ``qlayers`` mirrors ``static``: conv/linear entries are
    ``{"w_q": int8, "b_int": int32, "mult": float32 tensor or None}``
    (``None`` marks the logits layer), pool/flatten entries ``None``.
    Identity semantics (``eq=False``) keep the net hashable so weakrefs
    to it key the plan caches.
    """

    static: Static
    num_steps: int
    weight_bits: int
    qlayers: List[Optional[dict]] = dataclasses.field(default_factory=list)
    input_scale: float = 1.0
    logit_scale: float = 1.0
    encoding: Optional[EncodingSpec] = None

    @property
    def spec(self) -> EncodingSpec:
        """The net's encoding spec (radix when unset)."""
        if self.encoding is not None:
            return self.encoding
        return RadixEncoding(self.num_steps)


def convert(static: Static, params, calib_x: torch.Tensor, *,
            num_steps: Optional[int] = None,
            encoding: Optional[EncodingSpec] = None,
            weight_bits: int = 3, percentile: float = 99.9,
            per_channel: bool = False) -> QuantizedNet:
    """ANN -> SNN conversion with scales folded (see module docstring).

    Pass ``encoding`` (``RadixEncoding(T)``) or, as shorthand for radix,
    ``num_steps``.  Raises ``ValueError`` for neither, a contradictory
    pair, or a pool mode the encoding does not preserve.
    """
    spec = encoding
    if spec is None:
        if num_steps is None:
            raise ValueError("pass num_steps (radix shorthand) or encoding")
        spec = RadixEncoding(num_steps)
    elif num_steps is not None and num_steps != spec.num_steps:
        raise ValueError(
            f"num_steps={num_steps} contradicts "
            f"encoding.num_steps={spec.num_steps}")
    spec.validate_static(static)
    scales = calibrate(static, params, calib_x, percentile)
    scales = [s * spec.scale_factor for s in scales]
    lvlp1 = spec.levels

    qlayers: List[Optional[dict]] = []
    affine_idx = 0
    n_affine = sum(1 for k, _ in static if k in ("conv", "linear"))
    s_in = scales[0]
    input_scale = s_in
    pending_pool_div = 1.0
    logit_scale = 1.0
    for (kind, cfg), p in zip(static, params):
        if kind in ("conv", "linear"):
            affine_idx += 1
            w_q, s_w = quantize_weights(p["w"], weight_bits, per_channel)
            if per_channel:
                acc_unit = _div((s_in / lvlp1) * s_w, pending_pool_div)
            else:
                acc_unit = (s_in / lvlp1) * s_w / pending_pool_div
            b_int = torch.round(_div(p["b"], acc_unit)).to(torch.int32)
            if affine_idx < n_affine:
                s_out = scales[affine_idx]
                if per_channel:
                    mult = _div(acc_unit * lvlp1, s_out)
                else:
                    mult = torch.tensor(acc_unit * lvlp1 / s_out,
                                        dtype=torch.float32,
                                        device=p["w"].device)
                qlayers.append({"w_q": w_q, "b_int": b_int, "mult": mult})
                s_in = s_out
            else:
                logit_scale = acc_unit
                qlayers.append({"w_q": w_q, "b_int": b_int, "mult": None})
            pending_pool_div = 1.0
        elif kind == "pool":
            if cfg.get("mode", "or") == "avg":
                pending_pool_div = float(cfg["window"] ** 2)
            qlayers.append(None)
        elif kind == "flatten":
            qlayers.append(None)
        else:
            raise ValueError(kind)

    return QuantizedNet(
        static=static,
        num_steps=spec.num_steps,
        weight_bits=weight_bits,
        encoding=spec,
        qlayers=qlayers,
        input_scale=float(input_scale),
        logit_scale=(logit_scale if torch.is_tensor(logit_scale)
                     else float(logit_scale)),
    )
