"""LeNet-5 — the paper's primary evaluation network (port of ``repro/models/lenet.py``).

32x32x1 - 6C5 - P2 - 16C5 - P2 - 120C5 - 120 - 84 - 10.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

INPUT_HW: Tuple[int, int, int] = (32, 32, 1)
NUM_CLASSES = 10


def static(pool_mode: str = "avg", width_mult: float = 1.0):
    """Conversion-format layer description and channel counts."""
    c = lambda n: max(1, int(round(n * width_mult)))
    return (
        ("conv", {"stride": 1, "padding": "VALID"}),        # 6C5
        ("pool", {"window": 2, "mode": pool_mode}),
        ("conv", {"stride": 1, "padding": "VALID"}),        # 16C5
        ("pool", {"window": 2, "mode": pool_mode}),
        ("conv", {"stride": 1, "padding": "VALID"}),        # 120C5
        ("flatten", {}),
        ("linear", {}),                                     # 120
        ("linear", {}),                                     # 84
        ("linear", {}),                                     # 10
    ), (c(6), c(16), c(120), c(120), c(84))


def init(rng: np.random.Generator, width_mult: float = 1.0,
         num_classes: int = NUM_CLASSES):
    """He-initialized float32 parameters (CPU tensors) matching :func:`static`."""
    _, (c1, c2, c3, f1, f2) = static(width_mult=width_mult)
    shapes = [(5, 5, 1, c1), None, (5, 5, c1, c2), None, (5, 5, c2, c3),
              None, (c3, f1), (f1, f2), (f2, num_classes)]
    params = []
    for shp in shapes:
        if shp is None:
            params.append(None)
            continue
        fan_in = math.prod(shp[:-1])
        w = rng.standard_normal(shp, dtype=np.float32) \
            * np.float32(math.sqrt(2.0 / fan_in))
        params.append({"w": torch.from_numpy(w),
                       "b": torch.zeros(shp[-1], dtype=torch.float32)})
    return params


def make(rng: Optional[np.random.Generator] = None, pool_mode: str = "avg",
         width_mult: float = 1.0, num_classes: int = NUM_CLASSES):
    """(static, params, input_hw) triple ready for conversion."""
    rng = rng if rng is not None else np.random.default_rng(0)
    st, _ = static(pool_mode, width_mult)
    return st, init(rng, width_mult, num_classes), INPUT_HW
