"""Fang et al. CNN-2 — the cross-accelerator comparison network (port of
``repro/models/fang.py``).

28x28x1 - 32C3 - P2 - 32C3 - P2 - 256 - 10, SAME-padded convs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

INPUT_HW: Tuple[int, int, int] = (28, 28, 1)
NUM_CLASSES = 10


def static(pool_mode: str = "avg", width_mult: float = 1.0):
    """Conversion-format layer description and channel counts."""
    return (
        ("conv", {"stride": 1, "padding": "SAME"}),
        ("pool", {"window": 2, "mode": pool_mode}),
        ("conv", {"stride": 1, "padding": "SAME"}),
        ("pool", {"window": 2, "mode": pool_mode}),
        ("flatten", {}),
        ("linear", {}),
        ("linear", {}),
    ), (max(1, int(32 * width_mult)), max(1, int(32 * width_mult)),
        max(1, int(256 * width_mult)))


def init(rng: np.random.Generator, width_mult: float = 1.0,
         num_classes: int = NUM_CLASSES):
    """He-initialized float32 parameters (CPU tensors) matching :func:`static`."""
    _, (c1, c2, f1) = static(width_mult=width_mult)
    shapes = [(3, 3, 1, c1), None, (3, 3, c1, c2), None, None,
              (7 * 7 * c2, f1), (f1, num_classes)]
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
