"""Deterministic procedural datasets (port of ``repro/data/synthetic.py``).

``SyntheticVision`` draws class-conditional glyphs (oriented bar gratings
plus Gaussian blobs at class-keyed positions) with additive noise: the
image set the ANN trainer learns and conversion calibrates on.
``synthetic_tokens`` is an LM token stream with Zipfian unigram
statistics and a hidden linear-congruential structure.

Pure NumPy with a counter-based key, so a stream is restartable from a
step index; every output equals the reference's array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["SyntheticVision", "synthetic_tokens"]


@dataclasses.dataclass(frozen=True)
class SyntheticVision:
    """Class-conditional procedural images in [0, 1], NHWC."""

    input_hw: Tuple[int, int, int] = (32, 32, 1)
    num_classes: int = 10
    noise: float = 0.15
    seed: int = 0

    def batch(self, step: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic batch for a global step (restartable)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        h, w, c = self.input_hw
        labels = rng.integers(0, self.num_classes, size=batch_size)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        imgs = np.zeros((batch_size, h, w, c), np.float32)
        for i, lbl in enumerate(labels):
            # class-keyed deterministic geometry + per-sample jitter
            ang = np.pi * (lbl / self.num_classes) + rng.normal(0, 0.06)
            freq = 2.0 + (lbl % 5) + rng.normal(0, 0.1)
            phase = rng.uniform(0, 2 * np.pi)
            grating = 0.5 + 0.5 * np.sin(
                2 * np.pi * freq / h * (np.cos(ang) * yy + np.sin(ang) * xx) + phase)
            cy = h * (0.25 + 0.5 * ((lbl * 7919) % self.num_classes) / self.num_classes)
            cx = w * (0.25 + 0.5 * ((lbl * 104729) % self.num_classes) / self.num_classes)
            cy += rng.normal(0, 1.0)
            cx += rng.normal(0, 1.0)
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (h / 8) ** 2)))
            img = 0.55 * grating + 0.8 * blob
            img = img + rng.normal(0, self.noise, size=(h, w))
            for ch in range(c):
                imgs[i, :, :, ch] = img * (1.0 - 0.1 * ch)
        return np.clip(imgs, 0.0, 1.0), labels.astype(np.int32)

    def calibration_batch(self, batch_size: int = 256) -> np.ndarray:
        return self.batch(step=2**31 - 1, batch_size=batch_size)[0]


def synthetic_tokens(
    step: int,
    batch_size: int,
    seq_len: int,
    vocab: int,
    *,
    seed: int = 0,
    order: int = 3,
) -> np.ndarray:
    """(batch, seq_len+1) int32 tokens; [:, :-1] inputs / [:, 1:] labels.

    A hidden per-sequence LCG state mixes with the last ``order`` tokens to
    pick the next token from a Zipf-restricted candidate set, so the stream
    has both local structure (learnable) and a heavy-tailed unigram
    distribution (realistic softmax pressure).
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipfian candidate table: token t's probability ~ 1/(t+10)
    out = np.empty((batch_size, seq_len + 1), np.int64)
    state = rng.integers(1, 2**31 - 1, size=batch_size)
    hist = rng.integers(0, vocab, size=(batch_size, order))
    zipf_cap = max(64, vocab // 64)
    for t in range(seq_len + 1):
        state = (1103515245 * state + 12345) % (2**31)
        mix = (state + (hist * [[3, 5, 7][i % 3] for i in range(order)]).sum(1)) % (2**31)
        # structured choice: map mix into a zipf-ish region, plus noise escape
        base = (mix % zipf_cap).astype(np.int64)
        noise_mask = rng.random(batch_size) < 0.1
        noise_tok = rng.integers(0, vocab, size=batch_size)
        tok = np.where(noise_mask, noise_tok, base % vocab)
        out[:, t] = tok
        hist = np.concatenate([hist[:, 1:], tok[:, None]], axis=1)
    return out.astype(np.int32)
