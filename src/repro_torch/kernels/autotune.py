"""Launch-parameter autotuner for the radix kernels (port of
``repro/kernels/autotune.py``).

What a launch can vary on Hopper is not what it varied on the TPU.  The
reference swept Pallas tiles, MXU dot lowerings and a plane-parallel grid;
here every candidate is the hand-written kernel itself, and the choices
are its launch parameters:

* **radix matmul / conv** (``csrc/radix_common.cuh``): the block tile, one
  of the compiled ``gemm.TILES``, and the split-K count (blocks along K);
* **decode attention** (``csrc/radix_attn.cu``): the KV split,
  ``(split_slots, max_splits)``.

The default :class:`KernelConfig` is exactly the untuned launch
(``gemm.plan``'s tile and split, the module's ``SPLIT_SLOTS``/
``MAX_SPLITS``), and it is always the first candidate, so an interrupted
or all-tied sweep never regresses below it.  On a CUDA tensor the
candidates are kernel launches only: the plain PyTorch versions are for
tests and never run on the main path.  On a CPU tensor the only candidate
is the plain version.

Every GEMM candidate gives the same integers: the u8 x s8 -> s32 MMA is
exact while ``operand * 127 * K < 2^31`` (:func:`exact_lowering`), and
split-K adds int32 partials, whose sum does not depend on the split.  An
attention split changes the float order of the softmax combine, so the
plain version takes the same ``splits`` and repeats the tuned launch bit
for bit.

:func:`tune` times the candidates with the caller's builder (CUDA events
on the card) and keeps the winner in a process table backed by an on-disk
JSON table (``REPRO_TORCH_AUTOTUNE_CACHE``; the reference's
``REPRO_AUTOTUNE_CACHE`` holds records of another shape).  The winner is
the least time, ties broken by candidate order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import gemm
from repro_torch.kernels.radix_attn import (MAX_SPLITS, SPLIT_SLOTS,
                                            check_splits, split_slots)

__all__ = [
    "IMPLS",
    "TILES",
    "SPLITS",
    "ATTN_SPLITS",
    "KernelConfig",
    "AutotuneCache",
    "AutotuneStats",
    "exact_lowering",
    "matmul_key",
    "conv_key",
    "attn_key",
    "matmul_candidates",
    "conv_candidates",
    "attn_candidates",
    "measure",
    "tune",
    "default_cache",
    "reset_default_cache",
    "cache_path",
]

IMPLS = ("cuda", "plain")
TILES = tuple((t.act, t.w, t.bk) for t in gemm.TILES)
"""The (bm, bn, bk) tiles compiled into ``csrc/radix_common.cuh``: bm level
rows (M), bn weight rows (N), bk K bytes."""
SPLITS = (1, 2, 4, 8)
"""Split-K counts swept beside ``gemm.plan``'s own, up to K's tiles."""
ATTN_SPLITS = ((32, 32), (64, 32), (32, 16), (64, 16))
"""(split_slots, max_splits) pairs swept for decode attention."""
_ACC_LIMIT = 1 << 31           # int32 accumulator
_WEIGHT_MAX = 127              # int8 weight magnitude bound
_BYTE_MAX = 255                # a uint8 operand (a byte group of a carry)
_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One layer's launch: ``impl="cuda"`` is the hand-written kernel (its
    plain version on a CPU tensor), ``impl="plain"`` pins the plain
    PyTorch version on any device (the counterpart of the reference's
    ``impl="xla"`` twin; tests and reference paths only).

    GEMMs: the tile ``(bm, bn, bk)``, one of :data:`TILES`, and ``split``
    blocks along K; zeros leave each to ``gemm.plan``.  Attention: the KV
    split ``(split_slots, max_splits)``.  ``KernelConfig()`` is the
    untuned launch."""

    impl: str = "cuda"
    bm: int = 0
    bn: int = 0
    bk: int = 0
    split: int = 0
    split_slots: int = SPLIT_SLOTS
    max_splits: int = MAX_SPLITS

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")
        if (self.bm, self.bn, self.bk) != (0, 0, 0) and \
                (self.bm, self.bn, self.bk) not in TILES:
            raise ValueError(
                f"tile {(self.bm, self.bn, self.bk)} is not a compiled tile "
                f"{TILES} (or (0, 0, 0): gemm.plan's)")
        if self.split < 0:
            raise ValueError(f"split must be >= 0, got {self.split}")
        check_splits(self.split_slots, self.max_splits)

    @property
    def tile(self) -> Optional[gemm.Tile]:
        """The compiled tile, or None for ``gemm.plan``'s choice."""
        for t in gemm.TILES:
            if (t.act, t.w, t.bk) == (self.bm, self.bn, self.bk):
                return t
        return None

    @property
    def splits(self) -> Tuple[int, int]:
        """The attention launch's ``(split_slots, max_splits)``."""
        return (self.split_slots, self.max_splits)

    def launch(self, m: int, n: int, k: int, sms: int) -> gemm.Launch:
        """The GEMM launch this config makes for an (M, K) x (K, N)
        product on a card of ``sms`` SMs."""
        return gemm.plan(m, n, k, sms, tile=self.tile, split=self.split)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        return cls(**d)


# ---------------------------------------------------------------------------
# Exactness guard.
# ---------------------------------------------------------------------------


def exact_lowering(*, max_operand: int, k_contract: int,
                   method: str) -> bool:
    """True iff the u8 x s8 -> s32 tensor-core product is exact: every
    partial sum stays below 2^31 while ``operand * 127 * k_contract <
    2^31``.  The operand is a plane bit (1) bitserial, the level fused; a
    level wider than a byte (an int32 avg-pool carry) goes as byte groups,
    so a pass never sees more than 255.  ``k_contract`` is K for matmuls,
    ``kh * kw * Cin`` for convs."""
    if method not in ("fused", "bitserial"):
        raise ValueError(f"unknown method {method!r}")
    operand = 1 if method == "bitserial" else min(int(max_operand), _BYTE_MAX)
    return operand * _WEIGHT_MAX * int(k_contract) < _ACC_LIMIT


# ---------------------------------------------------------------------------
# Cache keys: one winner per (problem, schedule, dataflow, backend).
# ---------------------------------------------------------------------------


def _schedule_fields(schedule) -> Tuple[int, int, str]:
    """(packed_bits, periods, out_grid) of a KernelSchedule or bare T."""
    if hasattr(schedule, "packed_bits"):
        return (int(schedule.packed_bits), int(schedule.periods),
                str(schedule.out_grid))
    return (int(schedule), 1, "dense")


def _backend(backend) -> str:
    """The device type of ``backend`` (a device, or its name)."""
    return torch.device(backend).type


def matmul_key(m: int, k: int, n: int, schedule, dataflow: str, *,
               epilogue: bool, sparsity: bool, backend) -> tuple:
    """Winner-table key of a matmul problem: the shape, the full encoding
    schedule (radix T = 4 and phase T = 4 / P = 2 pack the same bytes and
    replay different planes), the output grid when an epilogue runs, the
    dataflow, the epilogue and sparsity flags, and the device type."""
    bits, periods, grid = _schedule_fields(schedule)
    return ("matmul", _backend(backend), int(m), int(k), int(n), bits,
            periods, grid if epilogue else "raw", str(dataflow),
            bool(epilogue), bool(sparsity))


def conv_key(h: int, w: int, cin: int, kh: int, kw: int, cout: int,
             stride: int, schedule, dataflow: str, *, batch: int,
             epilogue: bool, sparsity: bool, backend) -> tuple:
    """Winner-table key of a conv problem (the matmul key's rules)."""
    bits, periods, grid = _schedule_fields(schedule)
    return ("conv", _backend(backend), int(batch), int(h), int(w), int(cin),
            int(kh), int(kw), int(cout), int(stride), bits, periods,
            grid if epilogue else "raw", str(dataflow), bool(epilogue),
            bool(sparsity))


def attn_key(batch: int, s_len: int, hkv: int, g: int, hd: int,
             num_steps: int, dataflow: str, *, q_bits: int, packed: bool,
             sparsity: bool, backend) -> tuple:
    """Winner-table key of one decode-attention problem; the mask's content
    is not part of it (the split's cost depends on the shapes)."""
    return ("attn", _backend(backend), int(batch), int(s_len), int(hkv),
            int(g), int(hd), int(num_steps), int(q_bits), str(dataflow),
            bool(packed), bool(sparsity))


# ---------------------------------------------------------------------------
# Candidates.
# ---------------------------------------------------------------------------


def _dedup(cands: Sequence[KernelConfig]) -> List[KernelConfig]:
    seen, out = set(), []
    for c in cands:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _gemm_candidates(m: int, n: int, k: int, schedule, dataflow: str,
                     backend, sms: Optional[int]) -> List[KernelConfig]:
    """The untuned launch, then every compiled tile that fits M (the small
    tile alone at M <= ``gemm.SMALL_M``) times split-K in {``gemm.plan``'s,
    :data:`SPLITS`} up to K's tiles.  Given the card's ``sms``, a config
    that launches what an earlier one launches is dropped.  Only the
    default when the product is not provably exact."""
    if _backend(backend) != "cuda":
        return [KernelConfig(impl="plain")]
    default = KernelConfig()
    bits, _, _ = _schedule_fields(schedule)
    if not exact_lowering(max_operand=(1 << bits) - 1, k_contract=k,
                          method=dataflow):
        return [default]
    heuristic = gemm.tile_for(m, n)
    cands = [default]
    for tile in gemm.TILES:
        if m <= gemm.SMALL_M and tile is not gemm.SMALL:
            continue
        k_tiles = max(1, -(-k // tile.bk))
        for split in (0,) + SPLITS:
            if split > k_tiles or (tile is heuristic and split == 0):
                continue
            cands.append(KernelConfig(bm=tile.act, bn=tile.w, bk=tile.bk,
                                      split=split))
    if sms is None:
        return _dedup(cands)
    launches, out = set(), []
    for c in cands:
        launch = c.launch(m, n, k, sms)
        if launch not in launches:
            launches.add(launch)
            out.append(c)
    return out


def matmul_candidates(m: int, k: int, n: int, schedule, dataflow: str, *,
                      backend, sms: Optional[int] = None
                      ) -> List[KernelConfig]:
    """Legal launches of one (M, K) x (K, N) matmul problem, the untuned
    default first; on a CPU tensor the plain version alone."""
    return _gemm_candidates(m, n, k, schedule, dataflow, backend, sms)


def conv_candidates(h: int, w: int, cin: int, kh: int, kw: int, cout: int,
                    stride: int, schedule, dataflow: str, *, batch: int,
                    backend, sms: Optional[int] = None
                    ) -> List[KernelConfig]:
    """Legal launches of one VALID conv problem on pre-padded ``(batch, h,
    w, cin)`` input: the implicit GEMM's M = batch * h_out * w_out, K =
    kh * kw * cin, N = cout."""
    m = batch * ((h - kh) // stride + 1) * ((w - kw) // stride + 1)
    return _gemm_candidates(m, cout, kh * kw * cin, schedule, dataflow,
                            backend, sms)


def attn_candidates(s_len: int, *, backend) -> List[KernelConfig]:
    """Legal KV splits of one decode-attention problem: the untuned
    default, then each :data:`ATTN_SPLITS` pair that cuts ``s_len``
    otherwise than every earlier candidate (one split is one launch
    whatever its size); on a CPU tensor the plain version alone."""
    if _backend(backend) != "cuda":
        return [KernelConfig(impl="plain")]

    def cut(slots=None, most=None):
        size = split_slots(s_len, slots, most)
        return (size,) if size < s_len else ()

    cands, cuts = [KernelConfig()], {cut()}
    for slots, most in ATTN_SPLITS:
        if cut(slots, most) not in cuts:
            cuts.add(cut(slots, most))
            cands.append(KernelConfig(split_slots=slots, max_splits=most))
    return cands


# ---------------------------------------------------------------------------
# The cache: process table + on-disk JSON table.
# ---------------------------------------------------------------------------


def cache_path() -> Optional[pathlib.Path]:
    """On-disk table: ``$REPRO_TORCH_AUTOTUNE_CACHE`` (an empty value
    disables persistence), else ``~/.cache/repro_torch/autotune.json``."""
    env = os.environ.get(_ENV)
    if env is not None:
        return pathlib.Path(env) if env else None
    return pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json"


def _key_str(key: tuple) -> str:
    return "|".join(str(part) for part in key)


@dataclasses.dataclass
class AutotuneStats:
    """Counters that show steady state never re-sweeps."""

    hits: int = 0         # winner served (process table or disk)
    misses: int = 0       # key in neither table
    sweeps: int = 0       # candidate sweeps actually timed
    disk_hits: int = 0    # hits resolved from the on-disk table
    skipped: int = 0      # candidates whose build or run raised

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AutotuneCache:
    """Winner table: a process dict backed by an on-disk JSON file.

    Lookups try the process table, then the disk table (read once, lazily),
    then report a miss; :meth:`put` writes through to disk (an unwritable
    path leaves the process table alone).  A corrupt file is a cold
    cache.  Thread-safe."""

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.stats = AutotuneStats()
        self._mem: dict = {}
        self._disk_loaded = False
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._mem)

    def _load_disk(self) -> None:
        if self._disk_loaded:
            return
        self._disk_loaded = True
        if self.path is None or not self.path.exists():
            return
        try:
            payload = json.loads(self.path.read_text())
            for ks, entry in payload.get("entries", {}).items():
                self._mem.setdefault(
                    ks, (KernelConfig.from_dict(entry["config"]),
                         float(entry.get("us", 0.0))))
        except (OSError, ValueError, TypeError, KeyError, AttributeError):
            pass                      # a corrupt table is a cold cache

    def get(self, key: tuple) -> Optional[KernelConfig]:
        ks = _key_str(key)
        with self._lock:
            hit = self._mem.get(ks)
            if hit is None:
                self._load_disk()
                hit = self._mem.get(ks)
                if hit is not None:
                    self.stats.disk_hits += 1
            if hit is None:
                self.stats.misses += 1
                return None
            self.stats.hits += 1
            return hit[0]

    def put(self, key: tuple, config: KernelConfig, us: float) -> None:
        with self._lock:
            self._load_disk()
            self._mem[_key_str(key)] = (config, float(us))
            self._flush()

    def _flush(self) -> None:
        if self.path is None:
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            payload = {"version": 1, "entries": {
                ks: {"config": cfg.as_dict(), "us": us}
                for ks, (cfg, us) in sorted(self._mem.items())}}
            self.path.write_text(json.dumps(payload, indent=1) + "\n")
        except OSError:
            pass                      # read-only: process table only


_DEFAULT_CACHE: Optional[AutotuneCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> AutotuneCache:
    """The process-wide winner table (made on first use)."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        if _DEFAULT_CACHE is None:
            _DEFAULT_CACHE = AutotuneCache(cache_path())
        return _DEFAULT_CACHE


def reset_default_cache() -> None:
    """Drop the process-wide table (it then reads a changed
    ``REPRO_TORCH_AUTOTUNE_CACHE``)."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        _DEFAULT_CACHE = None


# ---------------------------------------------------------------------------
# Timing and winner selection.
# ---------------------------------------------------------------------------

_SLEEP_CYCLES = 1 << 20
"""Cycles the card spins before each timed run (about 0.5 ms), so the host
has queued the run's launches before its start event fires and the events
bracket device time, not the host's launch overhead."""


def measure(fn: Callable[[], object], *, iters: int = 5,
            warmup: int = 1) -> float:
    """Min-of-N time of ``fn()`` in microseconds, after ``warmup`` runs.
    When ``fn`` returns a CUDA tensor, each run is bracketed by CUDA
    events on the current stream, behind a short device spin, and the
    stream is synchronized; otherwise the host clock times it.  Min, not
    mean: noise only adds time."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn()
    if torch.is_tensor(out) and out.device.type == "cuda":
        stream = torch.cuda.current_stream(out.device)
        stream.synchronize()
        best = float("inf")
        with torch.cuda.device(out.device):
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_SLEEP_CYCLES)
                start.record(stream)
                fn()
                end.record(stream)
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e3)
        return best
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def tune(key: tuple, candidates: Sequence[KernelConfig],
         build: Callable[[KernelConfig], Callable[[], object]], *,
         cache: Optional[AutotuneCache] = None,
         timer: Optional[Callable[[Callable[[], object]], float]] = None,
         iters: int = 5,
         on_result: Optional[Callable[[KernelConfig, Optional[float]],
                                      None]] = None) -> KernelConfig:
    """The winner for ``key``: the cached one, else the fastest candidate.

    ``build(config)`` returns a thunk that runs the launch on
    representative inputs; ``timer`` (tests pass a fake) maps a thunk to
    microseconds, by default :func:`measure`.  A candidate whose build or
    run raises is skipped and counted (``stats.skipped``); the winner is
    the least time, ties broken by candidate order, and is cached in the
    process and on disk.  ``on_result(config, us)`` sees each candidate's
    time (None when skipped)."""
    cache = cache if cache is not None else default_cache()
    hit = cache.get(key)
    if hit is not None:
        return hit
    if not candidates:
        raise ValueError("no candidates to tune over")
    timer = timer if timer is not None else (
        lambda fn: measure(fn, iters=iters))
    best: Optional[Tuple[float, int, KernelConfig]] = None
    for idx, cand in enumerate(candidates):
        try:
            us = float(timer(build(cand)))
        except Exception:             # a launch the problem refuses
            cache.stats.skipped += 1
            if on_result is not None:
                on_result(cand, None)
            continue
        if on_result is not None:
            on_result(cand, us)
        if best is None or (us, idx) < (best[0], best[1]):
            best = (us, idx, cand)
    cache.stats.sweeps += 1
    if best is None:
        raise RuntimeError(f"autotune: every candidate failed for key {key}")
    cache.put(key, best[2], best[0])
    return best[2]
