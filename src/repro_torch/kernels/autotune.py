"""Kernel strategy record (port of ``KernelConfig`` in ``repro/kernels/autotune.py``).

Only the record a compiled plan keeps per layer is ported.  The reference's
tuner, cache and candidate space (Pallas tiles, MXU lowerings,
plane-parallel grids) describe the TPU; the Hopper candidate space and
the tuner come with the autotune slice (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

__all__ = ["KernelConfig", "TILE", "IMPLS"]

IMPLS = ("cuda", "plain")

TILE = (64, 64, 32)
"""(bm, bn, bk) compiled into ``csrc/radix_common.cuh``."""


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One layer's execution strategy: ``impl="cuda"`` is the hand-written
    kernel (its plain version on CPU tensors) at the compiled tile shape;
    ``impl="plain"`` pins the plain PyTorch version on any device (the
    counterpart of the reference's ``impl="xla"`` twin)."""

    impl: str = "cuda"
    bm: int = TILE[0]
    bn: int = TILE[1]
    bk: int = TILE[2]

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")
        if (self.bm, self.bn, self.bk) != TILE:
            raise ValueError(
                f"tile {(self.bm, self.bn, self.bk)} is not the compiled "
                f"tile {TILE}; tile choice comes with the autotune slice")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
