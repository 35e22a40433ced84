"""The one traffic generator: every cell's inputs from its workload file's
parameters and the run's seed.

Each seed gets the same amount of work in another order, so that two
seeds differ no more than two runs of one seed: prompt lengths come in
pairs whose sum is fixed."""

from __future__ import annotations

from typing import List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def sub_seed(seed: int, stream: int) -> int:
    """A torch generator seed for stream ``stream`` of ``seed``."""
    return int(rng(seed, stream).integers(0, 2 ** 62))


def paired_lengths(n_pairs: int, lo: int, hi: int,
                   r: np.random.Generator) -> List[int]:
    """``2 n_pairs`` prompt lengths: each pair is L uniform on [lo, hi]
    and lo + hi - L, in random order."""
    out = []
    for _ in range(n_pairs):
        a = int(r.integers(lo, hi + 1))
        pair = [a, lo + hi - a]
        if r.integers(0, 2):
            pair.reverse()
        out += pair
    return out
