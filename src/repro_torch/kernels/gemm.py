"""Launch plan and weight layout of the tensor-core radix GEMM.

``csrc/radix_common.cuh`` is the mainloop that ``radix_matmul`` and
``radix_conv2d`` share: int8 MMAs over K-major tiles, three compiled
tiles, split-K.  What surrounds it lives here, in Python that the CPU
tests reach:

* **the weight layout** — the tensor cores read 8-bit operands K-major, so
  the kernels take weights as (N, K) (matmul) or (Cout, KH, KW, Cin)
  (conv), made once by :func:`matmul_kmajor` / :func:`conv_kmajor` where a
  plan takes its weights; :func:`matmul_logical` / :func:`conv_logical`
  view them back in the reference's (K, N) / HWIO layout;
* **the launch plan** — :func:`plan` picks the tile from M and N, splits K
  until the grid covers the card, or takes the tile and split an autotuned
  ``KernelConfig`` names (:func:`k_ranges` lists the splits);
  :func:`buffers` allocates the output and the split-K workspace;
* **the kernel's arithmetic twin** — :func:`emulate` computes the product
  the way a launch does (split-K ranges, byte groups of int32 levels,
  one byte-masked pass per plane) so the tests hold that decomposition
  against the reference on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

__all__ = ["Tile", "LARGE", "SMALL", "MID", "TILES", "SMALL_M", "Launch",
           "tile_for", "plan", "k_ranges", "buffers", "matmul_kmajor",
           "conv_kmajor", "matmul_logical", "conv_logical", "emulate"]


@dataclasses.dataclass(frozen=True)
class Tile:
    """A compiled block tile: ``act`` level rows (M) by ``w`` weight rows
    (N) of outputs, ``bk`` K bytes per shared-memory stage."""

    act: int
    w: int
    bk: int


LARGE = Tile(act=128, w=128, bk=64)    # radix::LargeTile, fused: WgTile
SMALL = Tile(act=32, w=128, bk=128)    # radix::SmallTile (operands swapped)
MID = Tile(act=128, w=64, bk=64)       # radix::MidTile
TILES = (LARGE, SMALL, MID)
"""The compiled tiles, in the order of the kernels' ``tile`` argument."""
SMALL_M = 32
"""M at or below which the small tile (weights on the MMA's 16-row side)
runs."""

BLOCKS_PER_SM = 2
"""Split K until the grid holds this many blocks per SM."""


@dataclasses.dataclass(frozen=True)
class Launch:
    tile: Tile
    split: int      # blocks along K (gridDim.z)
    k_chunk: int    # K per split, a multiple of tile.bk

    @property
    def index(self) -> int:
        """The kernels' ``tile`` argument."""
        return TILES.index(self.tile)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_for(m: int, n: int) -> Tile:
    """The small tile at M <= ``SMALL_M``, else the 64-column tile where N
    fits it, else the large one."""
    if m <= SMALL_M:
        return SMALL
    return MID if n <= MID.w else LARGE


def plan(m: int, n: int, k: int, sms: int, *, tile: Optional[Tile] = None,
         split: int = 0) -> Launch:
    """The launch of an (M, K) x (K, N) product: ``tile`` (default
    :func:`tile_for`'s) and ``split`` blocks along K (default: none while
    the output tiles fill ``sms`` SMs, else enough for ``BLOCKS_PER_SM *
    sms`` blocks), in whole ``bk`` tiles with none empty, so a split past
    K's tiles, or one that would leave a slice empty, comes out smaller.
    An autotuned ``KernelConfig`` names ``tile`` and ``split``."""
    tile = tile_for(m, n) if tile is None else tile
    tiles = _cdiv(m, tile.act) * _cdiv(n, tile.w)
    k_tiles = max(1, _cdiv(k, tile.bk))
    if split <= 0:
        split = 1
        if tiles < sms:
            split = _cdiv(BLOCKS_PER_SM * sms, tiles)
    per = _cdiv(k_tiles, min(split, k_tiles))
    return Launch(tile, _cdiv(k_tiles, per), per * tile.bk)


def k_ranges(k: int, launch: Launch) -> List[Tuple[int, int]]:
    """The K range ``[lo, hi)`` each split covers."""
    return [(z * launch.k_chunk, min(k, (z + 1) * launch.k_chunk))
            for z in range(launch.split)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device: torch.device) -> Optional[int]:
    """The SM count of a CUDA ``device`` (its current card when it names
    none); None off CUDA."""
    if device.type != "cuda":
        return None
    return sm_count(torch.cuda.current_device() if device.index is None
                    else device.index)


def buffers(m: int, n: int, launch: Launch, *, epilogue: bool, div: int,
            device, dtype: Optional[torch.dtype] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, workspace) for one launch; the output's ``dtype`` defaults to
    uint8 under an epilogue, else int32.  Split-K adds partials with int32
    atomics: straight into a zeroed int32 output when nothing follows the
    sum, else into a zeroed workspace of (M, N) partials and one arrival
    count per output tile, where the last block finishes the tile."""
    if dtype is None:
        dtype = torch.uint8 if epilogue else torch.int32
    if launch.split == 1:
        return torch.empty((m, n), dtype=dtype, device=device), None
    if not epilogue and div == 1:
        return torch.zeros((m, n), dtype=dtype, device=device), None
    tiles = _cdiv(m, launch.tile.act) * _cdiv(n, launch.tile.w)
    work = torch.zeros(m * n + tiles, dtype=torch.int32, device=device)
    return torch.empty((m, n), dtype=dtype, device=device), work


# ---------------------------------------------------------------------------
# Weight layout.
# ---------------------------------------------------------------------------


def matmul_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> contiguous (N, K): the layout the kernel reads."""
    return w.transpose(-1, -2).contiguous()


def conv_kmajor(w: torch.Tensor) -> torch.Tensor:
    """HWIO (KH, KW, Cin, Cout) -> contiguous (Cout, KH, KW, Cin): each
    output channel's K = KH*KW*Cin taps in the kernel's (r, c, ci) order."""
    return w.permute(3, 0, 1, 2).contiguous()


def matmul_logical(w_nk: torch.Tensor) -> torch.Tensor:
    """The (K, N) view of a K-major matmul weight."""
    return w_nk.transpose(-1, -2)


def conv_logical(w_ohwi: torch.Tensor) -> torch.Tensor:
    """The HWIO view of a K-major conv weight."""
    return w_ohwi.permute(1, 2, 3, 0)


# ---------------------------------------------------------------------------
# The launch's arithmetic, in PyTorch.
# ---------------------------------------------------------------------------


def _passes(num_steps: int, fused: bool, occ: Optional[torch.Tensor],
            groups: int) -> List[Tuple[int, int]]:
    """(byte group, byte mask) of every pass one K tile runs, as
    ``Gemm::run`` derives them from the schedule and the occupancy row."""
    occ_bits = [1 if occ is None else int(occ[s]) for s in range(num_steps)]
    if fused:
        mask = 0xFFFFFFFF if occ is None else sum(
            b << s for s, b in enumerate(occ_bits))
        return [(g, (mask >> 8 * g) & 0xFF) for g in range(groups)
                if (mask >> 8 * g) & 0xFF]
    return [(s // 8, 1 << s % 8) for s in range(min(num_steps, 8 * groups))
            if occ_bits[s]]


def emulate(x: torch.Tensor, w_nk: torch.Tensor, *, num_steps: int,
            fused: bool, periods: int = 1,
            occupancy: Optional[torch.Tensor] = None,
            launch: Launch) -> torch.Tensor:
    """The int32 sum a launch of ``launch`` computes for (M, K) levels ``x``
    (uint8 or int32) and (N, K) weights: per split, per byte group, one
    byte-masked pass per plane (or one fused pass), partial sums wrapped to
    int32, combined ``<< 8g``, added over the splits, then divided by
    ``periods`` for bitserial."""
    wide = x.dtype == torch.int32
    groups = 4 if wide else 1
    xs = x.to(torch.int64) & 0xFFFFFFFF
    occ = None if occupancy is None else occupancy.reshape(-1)
    reps = 1 if fused else periods

    def wrap(t):
        return ((t + 2 ** 31) % 2 ** 32) - 2 ** 31

    total = torch.zeros((x.shape[0], w_nk.shape[0]), dtype=torch.int64)
    for lo, hi in k_ranges(x.shape[1], launch):
        part = torch.zeros_like(total)
        for g, byte_mask in _passes(num_steps, fused, occ, groups):
            plane = (xs[:, lo:hi] >> 8 * g) & byte_mask   # u8 operand
            prod = plane @ w_nk[:, lo:hi].to(torch.int64).T
            part = wrap(part + wrap(reps * prod) * 2 ** (8 * g))
        total = wrap(total + part)
    if not fused and periods > 1:
        total = torch.div(total, periods, rounding_mode="floor")
    return total.to(torch.int32)
