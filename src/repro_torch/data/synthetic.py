"""Deterministic synthetic LM token stream (port of
``repro/data/synthetic.py:synthetic_tokens``, that function only).

Pure NumPy with a counter-based key, so a stream is restartable from a
step index; the output equals the reference's array for array.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_tokens"]


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
