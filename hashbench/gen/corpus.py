"""A Table-1-sized corpus of padded sparse rows, made on the device.

Lengths (nonzeros a document) are lognormal with the configured median
and mean, σ = sqrt(2·ln(mean / median)), rounded, and held to [1, cap];
ids are uniform in [0, D).  Documents are sorted by length and cut into
chunks of padded int32 rows: a chunk holds at most ``max_rows`` rows and
``max_slots`` padded slots, and its width is its longest row rounded up
to a multiple of ``width_multiple``.  Every slot, padding included, holds
a random id, so a kernel that reads past a row's nnz gives other codes.

The lengths are drawn once from the configuration's ``instance_seed``,
so every run hashes the same number of ids in the same chunks; the ids
are drawn from the run's seed.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from hashbench.gen import generator


class Chunk(NamedTuple):
    start: int          # the first document's index in length order
    rows: int
    width: int


def lognormal_sigma(median: float, mean: float) -> float:
    return math.sqrt(2.0 * math.log(mean / median))


def doc_lengths(n_docs: int, median: float, mean: float, cap: int,
                seed: int, device: torch.device) -> torch.Tensor:
    """int64 (n_docs,) lengths, sorted ascending."""
    g = generator(seed, "doc_lengths", device)
    z = torch.randn(n_docs, generator=g, device=device, dtype=torch.float64)
    lens = torch.exp(math.log(median) + lognormal_sigma(median, mean) * z)
    lens = torch.round(lens).clamp(1, cap).to(torch.int64)
    return torch.sort(lens).values


def capped_mean(median: float, mean: float, cap: int) -> float:
    """E[min(L, cap)] of the (unrounded) lognormal law."""
    mu, s = math.log(median), lognormal_sigma(median, mean)
    phi = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    c = math.log(cap)
    return (mean * phi((c - mu - s * s) / s)
            + cap * (1.0 - phi((c - mu) / s)))


def chunk_plan(lengths: np.ndarray, max_rows: int, max_slots: int,
               width_multiple: int) -> List[Chunk]:
    """Greedy cut of ascending ``lengths``: each chunk takes the most rows
    that keep rows ≤ max_rows and rows · width ≤ max_slots."""
    lengths = np.asarray(lengths, dtype=np.int64)
    widths = -(-lengths // width_multiple) * width_multiple
    if widths.size and widths[-1] > max_slots:
        raise ValueError(f"a row of {lengths[-1]} ids exceeds the chunk "
                         f"limit of {max_slots} slots")
    out, start, n = [], 0, lengths.size
    while start < n:
        lo, hi = 1, min(max_rows, n - start)
        while lo < hi:               # the most rows whose slots fit
            mid = (lo + hi + 1) // 2
            if mid * widths[start + mid - 1] <= max_slots:
                lo = mid
            else:
                hi = mid - 1
        out.append(Chunk(start, lo, int(widths[start + lo - 1])))
        start += lo
    return out


def make_corpus(cfg: dict, traffic: dict, seed: int, device: torch.device
                ) -> Tuple[List[Chunk], List[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """→ (chunk plan, [(ids int32 (rows, width), nnz int32 (rows,))])."""
    lens = doc_lengths(cfg["n_docs"], cfg["nnz_median"], cfg["nnz_mean"],
                       cfg["nnz_cap"], cfg["instance_seed"], device)
    plan = chunk_plan(lens.cpu().numpy(), traffic["chunk_max_rows"],
                      traffic["chunk_max_slots"], traffic["width_multiple"])
    g = generator(seed, "doc_ids", device)
    lens32 = lens.to(torch.int32)
    chunks = []
    for c in plan:
        ids = torch.randint(0, cfg["ambient_dim"], (c.rows, c.width),
                            generator=g, device=device, dtype=torch.int32)
        chunks.append((ids, lens32[c.start:c.start + c.rows].contiguous()))
    return plan, chunks
