"""VGG-11 — the paper's scalability demonstrator (port of ``repro/models/vgg.py``).

8 SAME 3x3 convs + 5 pools + 3 linears (the VGG-11 'A' configuration);
``input_hw`` defaults to 224.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

NUM_CLASSES = 100
CONV_CHANNELS = (64, 128, 256, 256, 512, 512, 512, 512)
POOL_AFTER = (0, 1, 3, 5, 7)

# CPU smoke preset: CIFAR-shaped input; width 0.1 gives channel counts that
# are not multiples of 8 (6, 12, 25, 51, ...).
SMOKE_KWARGS = {"input_hw": (32, 32, 3), "width_mult": 0.1,
                "num_classes": 10}


def static(pool_mode: str = "avg", width_mult: float = 1.0):
    layers = []
    chans = []
    for i in range(8):
        layers.append(("conv", {"stride": 1, "padding": "SAME"}))
        chans.append(max(1, int(CONV_CHANNELS[i] * width_mult)))
        if i in POOL_AFTER:
            layers.append(("pool", {"window": 2, "mode": pool_mode}))
    layers.append(("flatten", {}))
    layers += [("linear", {}), ("linear", {}), ("linear", {})]
    chans += [max(1, int(4096 * width_mult)), max(1, int(4096 * width_mult))]
    return tuple(layers), tuple(chans)


def _he(rng: np.random.Generator, shp) -> torch.Tensor:
    fan_in = math.prod(shp[:-1])
    w = rng.standard_normal(shp, dtype=np.float32)
    w *= np.float32(math.sqrt(2.0 / fan_in))
    return torch.from_numpy(w)


def init(rng: np.random.Generator,
         input_hw: Tuple[int, int, int] = (224, 224, 3),
         width_mult: float = 1.0, num_classes: int = NUM_CLASSES):
    """He-initialized float32 parameters (CPU tensors) matching :func:`static`."""
    st, chans = static(width_mult=width_mult)
    h, w, c_in = input_hw
    params = []
    i = 0
    feat = None
    for kind, _ in st:
        if kind == "conv":
            c_out = chans[i]
            params.append({"w": _he(rng, (3, 3, c_in, c_out)),
                           "b": torch.zeros(c_out, dtype=torch.float32)})
            c_in = c_out
            i += 1
        elif kind == "pool":
            params.append(None)
            h, w = h // 2, w // 2
        elif kind == "flatten":
            params.append(None)
            feat = h * w * c_in
        elif kind == "linear":
            f_out = chans[i] if i < len(chans) else num_classes
            i += 1
            params.append({"w": _he(rng, (feat, f_out)),
                           "b": torch.zeros(f_out, dtype=torch.float32)})
            feat = f_out
    return params


def make(rng: Optional[np.random.Generator] = None, pool_mode: str = "avg",
         input_hw: Tuple[int, int, int] = (224, 224, 3),
         width_mult: float = 1.0, num_classes: int = NUM_CLASSES):
    """(static, params, input_hw) triple ready for conversion."""
    rng = rng if rng is not None else np.random.default_rng(0)
    st, _ = static(pool_mode, width_mult)
    return st, init(rng, input_hw, width_mult, num_classes), input_hw
