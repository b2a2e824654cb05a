"""Random projections (paper §5.1), the other baseline family
(counterpart of ``repro/core/random_projection.py``).

v_j = Σ_i u_i · r_ij with E r=0, Var r=1, E r³=0, E r⁴=s (paper Eq. 10);
the sparse-projection distribution of Eq. 11 for general s.  The
estimator â_rp = (1/k) Σ_j v1_j v2_j is unbiased (Eq. 12) with variance
Eq. 13.  The D×k matrix is never materialized: r_ij comes from a
counter-based hash of (i, j), the reference's fmix32 words (int64 in
[0, 2^32), ``core/universal_hash.py``), so the entries are the
reference's; the projection is computed in chunks of ``j_chunk``
projection ids, as the reference scans them.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import SparseBatch
from repro_torch.core.universal_hash import MASK32, fmix32, mul32


def _r_ij(indices: torch.Tensor, j: torch.Tensor, s: int,
          seed: int) -> torch.Tensor:
    """float32 r for feature ids ``indices`` [...] and projection ids j
    [J] → [..., J]."""
    iu = (indices.to(torch.int64) & MASK32)[..., None]
    ju = j.to(torch.int64) & MASK32
    # double-mix combiner: premix i with the seed, then remix with j (a
    # single xor/multiply combine of (i, j) leaves sign correlations)
    pre = fmix32((iu + ((seed * 0x632BE59B) & MASK32)) & MASK32)
    h = fmix32((pre + mul32(ju, 0x9E3779B9)) & MASK32)
    sign = torch.where((h >> 31) & 1 == 1, 1.0, -1.0).to(torch.float32)
    if s == 1:
        return sign
    f32 = dict(dtype=torch.float32, device=indices.device)
    u = (h & 0x7FFFFFFF).to(torch.float32) / 2.0 ** 31
    keep = u < torch.tensor(1.0 / s, **f32)
    return torch.where(keep, sign * torch.sqrt(torch.tensor(float(s), **f32)),
                       0.0)


def rp_project_sparse(
    indices: torch.Tensor,
    mask: torch.Tensor,
    values,
    k: int,
    s: int = 1,
    seed: int = 0,
    j_chunk: int = 128,
) -> torch.Tensor:
    """Projects a padded sparse batch to float32 (n, k), on its device."""
    vals = (values if values is not None
            else torch.ones(indices.shape, dtype=torch.float32,
                            device=indices.device))
    vals = torch.where(mask, vals, 0.0).to(torch.float32)
    outs = []
    for lo in range(0, k, j_chunk):
        j = torch.arange(lo, min(lo + j_chunk, k), device=indices.device)
        r = _r_ij(indices, j, s, seed)            # (n, m, j)
        outs.append(torch.einsum("nm,nmj->nj", vals, r))
    if not outs:
        return torch.zeros((indices.shape[0], 0), dtype=torch.float32,
                           device=indices.device)
    return torch.cat(outs, dim=1)


def rp_project_batch(batch: SparseBatch, k: int, s: int = 1,
                     seed: int = 0) -> torch.Tensor:
    return rp_project_sparse(batch.indices, batch.mask, batch.values,
                             k=k, s=s, seed=seed)


def rp_inner_product(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """â_rp,s = (1/k) Σ_j v1_j v2_j (paper Eq. 12)."""
    return torch.mean(v1 * v2, dim=-1)
