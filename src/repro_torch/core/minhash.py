"""Minwise hashing (counterpart of ``repro/core/minhash.py``).

  * ``minhash_torch`` — the multiply-shift family in torch, chunked over
    k (the twin of the reference's ``minhash_jnp``; kernel B3's plain
    version);
  * ``minhash_batch`` — ``minhash_torch`` over a ``core.types.SparseBatch``
    with a ``MultiplyShiftHash`` family;
  * ``minhash_numpy`` — the exact families (mod 2^61 − 1, explicit
    permutations), the offline path of ``preprocess_rows``.

Both return the raw minima z_j = min_{t∈S} h_j(t); b-bit codes are
``core.bbit.bbit_codes``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.universal_hash import (MASK32, ModPrimeHash,
                                             PermutationHash, fmix32,
                                             int32_to_words, mul32)

# hash lanes per pass: bounds the (n, m, chunk) int64 intermediate
K_CHUNK = 32


def minhash_torch(indices: torch.Tensor, mask: torch.Tensor,
                  a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min of fmix32(a_j·t + b_j) over each row's masked-in ids.

    indices: int32 (n, m); mask: bool (n, m); a, b: int64 words (k,).
    Returns int64 words (n, k); a row with no valid id holds 2^32 − 1.
    """
    t = (indices.to(torch.int64) & MASK32)[:, :, None]
    keep = mask[:, :, None]
    out = []
    for lo in range(0, a.shape[0], K_CHUNK):
        aj = a[lo: lo + K_CHUNK][None, None, :]
        bj = b[lo: lo + K_CHUNK][None, None, :]
        h = fmix32((mul32(t, aj) + bj) & MASK32)
        out.append(torch.where(keep, h, MASK32).amin(dim=1))
    return torch.cat(out, dim=1)


def minhash_batch(batch, family) -> torch.Tensor:
    """int64 words (n, k): ``minhash_torch`` of a ``SparseBatch`` under a
    ``MultiplyShiftHash`` family, on the batch's device."""
    a, b = family.params(batch.indices.device)
    return minhash_torch(batch.indices, batch.mask, int32_to_words(a),
                         int32_to_words(b))


def minhash_numpy(
    indices: np.ndarray,
    mask: np.ndarray,
    family: Union[ModPrimeHash, PermutationHash],
    k_chunk: int = 64,
) -> np.ndarray:
    """Exact offline min-hash (paper Eq. 17 family or true permutations)
    → uint64 (n, k); a row with no valid id holds 2^64 − 1."""
    n, m = indices.shape
    k = family.k
    out = np.full((n, k), np.iinfo(np.uint64).max, dtype=np.uint64)
    sentinel = np.uint64(np.iinfo(np.uint64).max)
    for start in range(0, k, k_chunk):
        stop = min(start + k_chunk, k)
        if isinstance(family, ModPrimeHash):
            sub = ModPrimeHash(c1=family.c1[start:stop],
                               c2=family.c2[start:stop])
        else:
            sub = PermutationHash(perms=family.perms[start:stop])
        h = sub(indices).astype(np.uint64)  # (n, m, kc)
        h = np.where(mask[:, :, None], h, sentinel)
        out[:, start:stop] = h.min(axis=1)
    return out


def collision_probability(z1: np.ndarray, z2: np.ndarray) -> float:
    """\\hat{R}_M — the fraction of matching min-hashes (paper Eq. 1)."""
    return float(np.mean(z1 == z2))
