"""Synthetic token/feature streams for the LM architecture zoo (counterpart
of ``repro/data/lm_synth.py``, numpy only: the same seed gives the same
bytes).

Used by per-arch smoke tests, the quickstart LM example, and any place
that needs deterministic token batches without real corpora.  Tokens
follow a Zipf law with short-range repetition structure so losses
actually decrease during smoke training.
"""
from __future__ import annotations

import numpy as np


def token_batch(
    batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    zipf_a: float = 1.2,
) -> np.ndarray:
    """int32 (batch, seq_len) Zipf tokens with local bigram structure."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    ranks = rng.zipf(zipf_a, size=(batch, seq_len)).astype(np.int64)
    toks = (ranks - 1) % max(vocab - 2, 1) + 1  # reserve 0 for padding
    # inject bigram predictability: every other token repeats prev+1
    rep = rng.random((batch, seq_len)) < 0.3
    rep[:, 0] = False
    shifted = np.roll(toks, 1, axis=1) + 1
    toks = np.where(rep, shifted % vocab, toks)
    return toks.astype(np.int32)


def lm_example_stream(batch: int, seq_len: int, vocab: int, seed: int = 0):
    """Yields (step, tokens, targets) forever; targets are next-token."""
    step = 0
    while True:
        toks = token_batch(batch, seq_len + 1, vocab, seed=seed + step)
        yield step, toks[:, :-1], toks[:, 1:]
        step += 1
