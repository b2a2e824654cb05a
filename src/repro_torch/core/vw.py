"""The VW hashing algorithm (paper §5.2): signed feature hashing
(counterpart of ``repro/core/vw.py``).

g_j = Σ_i u_i · r_i · 1{h(i) = j}   (paper Eq. 14), with r_i from the
two-point ±1 distribution (s = 1) or the sparse distribution of Eq. (11)
for s > 1.  The hash words are int64 in [0, 2^32), as in
``core/universal_hash.py``; bucket and sign streams are the reference's
bit for bit, so the same ids give the same sketch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.universal_hash import MASK32, fmix32, mul32
from repro_torch.kernels.vw_sketch import bucket_words, scatter_rows, signs


def _r_values(sign: torch.Tensor, indices: torch.Tensor, s: int,
              seed: int) -> torch.Tensor:
    """General r_i of Eq. (10)/(11): ±√s with probability 1/(2s) each,
    else 0."""
    if s == 1:
        return sign
    t = indices.to(torch.int64) & MASK32
    hz = fmix32((mul32(t, 0x2545F491) + ((seed + 7) & MASK32)) & MASK32)
    u = hz.to(torch.float32) / 2.0 ** 32
    f32 = dict(dtype=torch.float32, device=sign.device)
    keep = u < torch.tensor(1.0 / s, **f32)
    return torch.where(keep, sign * torch.sqrt(torch.tensor(float(s), **f32)),
                       0.0)


def vw_hash_sparse(indices: torch.Tensor, mask: torch.Tensor,
                   values: Optional[torch.Tensor], m: int, s: int = 1,
                   seed: int = 0) -> torch.Tensor:
    """VW-hashes a padded sparse batch (int ids (n, M), bool mask (n, M),
    float values or None for ones) into float32 (n, m) sketches;
    bucket = h mod m, so any m works."""
    bucket = bucket_words(indices, seed) % m
    r = _r_values(signs(indices, seed), indices, s, seed)
    vals = (torch.ones_like(r) if values is None
            else values.to(torch.float32))
    contrib = torch.where(mask, vals * r, 0.0)
    return scatter_rows(bucket, contrib, m)


def vw_hash_batch(batch, m: int, s: int = 1, seed: int = 0) -> torch.Tensor:
    """``vw_hash_sparse`` of a ``core.types.SparseBatch``."""
    return vw_hash_sparse(batch.indices, batch.mask, batch.values, m=m, s=s,
                          seed=seed)


def vw_inner_product(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """â_vw = Σ_j g1_j · g2_j (paper Eq. 15), not averaged over k."""
    return torch.sum(g1 * g2, dim=-1)
