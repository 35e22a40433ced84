"""VGG configurations: He weights, biases and images drawn on the device,
and the program's description of the net."""

from __future__ import annotations

import math
from typing import List

import torch

from bench.traffic import sub_seed
from bench.work.models import vgg_layers


def float_params(cfg: dict, seed: int, device) -> List[dict]:
    """One ``{"w", "b"}`` float32 dict per conv (HWIO) and linear ((F, G)):
    He-normal weights from one draw, biases uniform in
    ``[-bias_scale, bias_scale]`` from another."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    shapes = []
    for layer in vgg_layers(cfg):
        if layer[0] == "conv":
            shapes.append((3, 3, layer[3], layer[4]))
        elif layer[0] == "linear":
            shapes.append((layer[1], layer[2]))
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g,
                       device=device)
    bias = torch.rand(sum(s[-1] for s in shapes), generator=g,
                      device=device).mul_(2).sub_(1).mul_(cfg["bias_scale"])
    params, o, ob = [], 0, 0
    for s in shapes:
        n = math.prod(s)
        w = flat[o:o + n].view(s).mul_(math.sqrt(2.0 / math.prod(s[:-1])))
        params.append({"w": w, "b": bias[ob:ob + s[-1]]})
        o, ob = o + n, ob + s[-1]
    return params


def images(cfg: dict, seed: int, stream: int, count: int, device
           ) -> torch.Tensor:
    """``count`` images uniform in [0, 1), (count, H, W, C) float32."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    return torch.rand((count,) + tuple(cfg["input_hw"]), generator=g,
                      device=device)


def calibration(cfg: dict, seed: int, device) -> torch.Tensor:
    return images(cfg, seed, 1, cfg["calib_images"], device)


def program_net(cfg: dict, params: List[dict]):
    """The program's ``(static, params)``: its layer list (3x3 SAME convs,
    2x2 pools, a flatten, linears) with ``None`` for the layers without
    weights."""
    static, full, it = [], [], iter(params)
    flat = False
    for layer in vgg_layers(cfg):
        if layer[0] == "conv":
            static.append(("conv", {"stride": 1, "padding": "SAME"}))
            full.append(next(it))
        elif layer[0] == "pool":
            static.append(("pool", {"window": 2, "mode": cfg["pool_mode"]}))
            full.append(None)
        else:
            if not flat:
                static.append(("flatten", {}))
                full.append(None)
                flat = True
            static.append(("linear", {}))
            full.append(next(it))
    return tuple(static), full


def build(cfg: dict, seed: int, device, buckets):
    """Convert the seed's net with the program and compile it for
    ``buckets``: the program's ``Executable`` (its plans built and run
    once)."""
    from repro_torch import api

    static, params = program_net(cfg, float_params(cfg, seed, device))
    calib = calibration(cfg, seed, device)
    with torch.no_grad():
        qnet = api.convert(static, params, calib,
                           encoding=api.RadixEncoding(cfg["num_steps"]),
                           weight_bits=cfg["weight_bits"],
                           percentile=cfg["calib_percentile"])
    exe = api.Accelerator(backend=cfg["backend"], dataflow=cfg["dataflow"],
                          device=str(device)).compile(
        qnet, tuple(cfg["input_hw"]), buckets=tuple(buckets))
    return exe.warmup()


def reference_logits(cfg: dict, seed: int, x: torch.Tensor, block: int,
                     requant_dtype=torch.float32) -> torch.Tensor:
    """The plain reference's logits of ``x``, ``block`` images at a time,
    from the seed's float weights and calibration images drawn again."""
    from bench.reference import vgg_snn

    params = float_params(cfg, seed, x.device)
    net = vgg_snn.convert(cfg, params, calibration(cfg, seed, x.device))
    del params
    with torch.no_grad():
        return torch.cat([vgg_snn.forward(cfg, net, x[i:i + block],
                                          requant_dtype)
                          for i in range(0, len(x), block)])
