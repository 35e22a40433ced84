"""Integer radix SNN reference of the VGG configurations, with its own
ANN -> SNN conversion.

The conversion follows the port's published recipe (the paper's): a
float64 calibration forward whose activations are rounded once to
float32, scales at a percentile (float32 linear interpolation between
two order statistics), symmetric ``weight_bits`` weights against the
layer's absolute maximum, biases and requantization multipliers folded
from the scales.  The forward runs on radix levels: the input quantized
to ``2^T`` levels, every conv and linear an exact integer product plus
the integer bias, the output logic ``clip(floor(f32(acc) * mult), 0,
2^T - 1)``, 2x2 pooling as the bitwise OR of levels, and the logits
``f32(acc) * logit_scale``.

Integer products run as float32 products of small integers with TF32
and cuDNN off (cuDNN may pick a Winograd or FFT convolution, which is
not exact): every partial sum of these nets stays below 2^24 (at most
``(2^T - 1) * (2^(bits-1) - 1) * K`` with K <= 25088), so float32 sums
them exactly in any order.

``requant_dtype=torch.bfloat16`` is the control: the output logic's
float32 product taken in bfloat16, the next precision below."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from bench.reference import no_tf32
from bench.work.models import vgg_layers

__all__ = ["calibrate", "convert", "forward", "float_forward"]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _pool_windows(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)


def float_forward(cfg: dict, params: List[Optional[dict]], x: torch.Tensor
                  ) -> List[torch.Tensor]:
    """The float ANN's activations after each ReLU (every conv and linear
    but the last), NHWC, in ``x``'s dtype; pools take the max."""
    acts = []
    affine = [l for l in vgg_layers(cfg) if l[0] != "pool"]
    i = 0
    for layer in vgg_layers(cfg):
        if layer[0] == "pool":
            x = _pool_windows(x).amax(dim=(2, 4))
            continue
        p = params[i]
        i += 1
        if layer[0] == "conv":
            x = F.conv2d(F.pad(x, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2),
                         p["w"].to(x.dtype).permute(3, 2, 0, 1)
                         ).permute(0, 2, 3, 1)
        else:
            x = x.reshape(x.shape[0], -1) @ p["w"].to(x.dtype)
        x = x + p["b"].to(x.dtype)
        if i < len(affine):
            x = torch.relu(x)
            acts.append(x)
    return acts


def _percentile(a: torch.Tensor, percentile: float) -> float:
    """Float32 linear interpolation between the two order statistics at
    ``percentile * (n - 1) / 100``, the fused multiply-add of the two
    weighted values rounded once to float32."""
    a = a.reshape(-1)
    n = a.numel()
    f32 = dict(dtype=torch.float32)
    last = torch.tensor(float(n), **f32) - 1
    q = torch.tensor(percentile, **f32) * (
        (torch.tensor(1.0, **f32) / torch.tensor(100.0, **f32)) * last)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    if n - lo_i <= hi_i + 1:
        top = torch.topk(a, n - lo_i).values
        lo_v, hi_v = top[n - 1 - lo_i], top[n - 1 - hi_i]
    else:
        low_vals = torch.topk(a, hi_i + 1, largest=False).values
        lo_v, hi_v = low_vals[lo_i], low_vals[hi_i]
    lo_v, hi_v = lo_v.cpu(), hi_v.cpu()
    fused = hi_v.double() * high_w.double() + (lo_v * low_w).double()
    return float(fused.float())


def calibrate(cfg: dict, params, calib: torch.Tensor) -> List[float]:
    """Input scale, then one scale per activation feeding a conv or
    linear: float64 forward, each activation rounded to float32, its
    percentile (at least 1e-6)."""
    with torch.no_grad():
        p64 = [{k: v.to(torch.float64) for k, v in p.items()}
               for p in params]
        acts = float_forward(cfg, p64, calib.to(torch.float64))
        scales = [float(max(1.0, float(calib.max())))]
        for a in acts:
            scales.append(max(_percentile(a.to(torch.float32),
                                          cfg["calib_percentile"]), 1e-6))
    return scales


def convert(cfg: dict, params: List[dict], calib: torch.Tensor) -> dict:
    """``{"layers": [{"w_q", "b_int", "mult"}], "input_scale",
    "logit_scale"}``: ``params`` one ``{"w", "b"}`` per conv (HWIO) and
    linear ((F, G)), in order; the last layer's ``mult`` is None."""
    levels = 1 << cfg["num_steps"]
    qmax = 2 ** (cfg["weight_bits"] - 1) - 1
    scales = calibrate(cfg, params, calib)
    s_in = scales[0]
    out = {"layers": [], "input_scale": s_in, "logit_scale": 1.0}
    for i, p in enumerate(params):
        w = p["w"]
        s_w = max(float(w.abs().max()) / qmax, 1e-12)
        w_q = torch.clamp(torch.round(w / _f32(s_w, w)), -qmax, qmax
                          ).to(torch.int8)
        acc_unit = (s_in / levels) * s_w
        b_int = torch.round(p["b"] / _f32(acc_unit, w)).to(torch.int32)
        layer = {"w_q": w_q, "b_int": b_int, "mult": None}
        if i + 1 < len(params):
            s_out = scales[i + 1]
            layer["mult"] = _f32(acc_unit * levels / s_out, w)
            s_in = s_out
        else:
            out["logit_scale"] = acc_unit
        out["layers"].append(layer)
    return out


def _int_product(x: torch.Tensor, w_q: torch.Tensor, conv: bool
                 ) -> torch.Tensor:
    """Exact int32 conv (3x3, SAME) or matmul of levels and weights."""
    xf = x.to(torch.float32)
    wf = w_q.to(torch.float32)
    with no_tf32(), torch.backends.cudnn.flags(enabled=False):
        if conv:
            y = F.conv2d(F.pad(xf, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2),
                         wf.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        else:
            y = xf @ wf
    return torch.round(y).to(torch.int32)


def forward(cfg: dict, net: dict, x: torch.Tensor,
            requant_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W, C) float images -> (N, classes) float32 logits."""
    lvl = (1 << cfg["num_steps"]) - 1
    q = torch.floor(x / _f32(net["input_scale"], x) * float(lvl + 1))
    q = torch.clamp(q, 0, lvl).to(torch.uint8)
    i = 0
    for layer in vgg_layers(cfg):
        if layer[0] == "pool":
            if cfg["pool_mode"] != "or":
                raise ValueError("the reference pools by OR only")
            win = _pool_windows(q)
            q = (win[:, :, 0, :, 0] | win[:, :, 0, :, 1]
                 | win[:, :, 1, :, 0] | win[:, :, 1, :, 1])
            continue
        p = net["layers"][i]
        i += 1
        if layer[0] == "linear":
            q = q.reshape(q.shape[0], -1)
        acc = _int_product(q, p["w_q"], layer[0] == "conv") + p["b_int"]
        if p["mult"] is None:
            return acc.to(torch.float32) * _f32(net["logit_scale"], acc)
        prod = acc.to(requant_dtype) * p["mult"].to(requant_dtype)
        q = torch.clamp(torch.floor(prod), 0, lvl).to(torch.uint8)
    raise ValueError("the configuration has no linear layer")
