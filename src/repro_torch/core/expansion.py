"""The 2^b × k one-hot expansion (paper §3) and its gather-form equivalent
(counterpart of ``repro/core/expansion.py``).

The paper materializes, for each example, a ``2^b·k``-dim binary vector
with exactly k ones and feeds it to LIBLINEAR.  The inner product of two
such vectors equals ``k · \\hat{P}_b``.  Provided:

  * ``expand``            — the explicit expansion (tests / tiny data only).
  * ``linear_forward``    — w·x without materializing the expansion:
                            ``Σ_j W[j, code_j]`` (a gather).
  * ``compact_index``     — the paper's §5.4 trick: a VW (signed feature
                            hashing) pass *on top of* the b-bit expansion
                            to shrink the index space when 2^b·k is much
                            larger than k, again without materializing.

Hash words are int64 in [0, 2^32) (``core/universal_hash.py``), so the
buckets and signs are the reference's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bbit import codes_agree
from repro_torch.core.universal_hash import MASK32, fmix32, mul32


def expand(codes: torch.Tensor, b: int) -> torch.Tensor:
    """Integer (n, k) codes → float32 (n, k·2^b) one-hot expansion."""
    n, k = codes.shape
    onehot = F.one_hot(codes.to(torch.int64), 1 << b).to(torch.float32)
    return onehot.reshape(n, k * (1 << b))


def expansion_offsets(codes: torch.Tensor, b: int) -> torch.Tensor:
    """int32 column index of each example's k ones in the expanded
    space."""
    k = codes.shape[-1]
    return (torch.arange(k, dtype=torch.int32, device=codes.device)
            * (1 << b) + codes.to(torch.int32))


def linear_forward(codes: torch.Tensor, weights: torch.Tensor, b: int,
                   scale: float = 1.0) -> torch.Tensor:
    """Logits of a linear model over the virtual expansion.

    Args:
      codes:   integer (n, k).
      weights: float (k, 2^b, n_out) weight table (the expanded weight
               vector reshaped; bias handled by caller).
      b:       bits per code.

    Returns:
      float (n, n_out) = expansion(codes) @ W_flat, computed as k gathers.
    """
    del b
    k = codes.shape[1]
    cols = torch.arange(k, device=codes.device)[None, :]
    gathered = weights[cols, codes.to(torch.int64)]       # (n, k, o)
    return gathered.sum(dim=1) * scale


def pb_hat(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """\\hat{P}_b between two code rows/batches (paper Eq. 6), float32."""
    return codes_agree(c1, c2)


def compact_index(codes: torch.Tensor, b: int, m: int,
                  seed_a: int = 0x9E3779B1,
                  seed_b: int = 0x85EBCA77) -> torch.Tensor:
    """Paper §5.4: VW hashing applied on top of the b-bit expansion.

    Maps each of the k virtual ones (at column ``j·2^b + code_j``) to one
    of ``m`` buckets with a ±1 sign, *without* materializing the 2^b·k
    vector.  Output: float32 (n, m) — a compact, dense representation
    whose inner products are unbiased estimates of k·P̂_b (VW is
    unbiased, paper Eq. 15).
    """
    cu = expansion_offsets(codes, b).to(torch.int64) & MASK32   # (n, k)
    h = fmix32((mul32(cu, seed_a & MASK32) + (seed_b & MASK32)) & MASK32)
    bucket = h % m
    # independent sign stream (decorrelated from the bucket hash)
    hs = fmix32(cu ^ 0xDEADBEEF)
    sign = torch.where((hs >> 31) & 1 == 1, 1.0, -1.0)
    n, k = codes.shape
    out = torch.zeros((n, m), dtype=torch.float32, device=codes.device)
    rows = torch.arange(n, device=codes.device)[:, None].expand(n, k)
    return out.index_put_((rows, bucket), sign, accumulate=True)
