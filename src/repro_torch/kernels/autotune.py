"""Kernel strategy record (port of ``KernelConfig`` in ``repro/kernels/autotune.py``).

Only the record a compiled plan keeps per layer is ported.  The reference's
tuner, cache and candidate space (Pallas tiles, MXU lowerings,
plane-parallel grids) describe the TPU; the Hopper candidate space and
the tuner come with the autotune slice (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import gemm

__all__ = ["KernelConfig", "TILE", "TILES", "IMPLS"]

IMPLS = ("cuda", "plain")

TILES = tuple((t.act, t.w, t.bk) for t in gemm.TILES)
"""The (bm, bn, bk) tiles compiled into ``csrc/radix_common.cuh``: bm level
rows (M), bn weight rows (N), bk K bytes; the launch picks one by M
(``gemm.tile_for``)."""
TILE = TILES[0]
"""The large-M tile, the record's default."""


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One layer's execution strategy: ``impl="cuda"`` is the hand-written
    kernel (its plain version on CPU tensors) at one of the compiled tiles;
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
        if (self.bm, self.bn, self.bk) not in TILES:
            raise ValueError(
                f"tile {(self.bm, self.bn, self.bk)} is not a compiled "
                f"tile {TILES}; tile choice comes with the autotune slice")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
