"""k-permutation minwise hashing in torch (counterpart of
``repro/core/minhash.py::minhash_jnp``)."""
from __future__ import annotations

import torch

from repro_torch.core.universal_hash import MASK32, fmix32, mul32

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
