"""One Permutation Hashing (counterpart of ``repro/core/oph.py``).

One multiply-shift + fmix32 hash per nonzero; the bin of feature t is
the top log2(k) bits of h(t) and each bin keeps its minimum.  Empty
bins are either densified by rotation (``oph``: borrow the nearest
non-empty bin to the right, circularly, plus distance·_ROT_C) or
zero-coded (``oph_zero``: marked in an empty mask).  Torch functions
hold 32-bit words in int64, as in ``core/universal_hash.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.universal_hash import (MASK32, fmix32, mul32,
                                             words_to_int32)

UINT32_MAX_NP = np.uint32(0xFFFFFFFF)

# Reserved uint16 code marking an empty bin under zero-coding.
OPH_EMPTY_CODE = np.uint16(0xFFFF)

# Rotation offset constant (odd); the kernels in csrc/fused_encode.cu
# use the same value.
_ROT_C = 0x9E3779B1


def _check_k(k: int) -> int:
    """OPH bins must be a power of two; returns the bin shift 32-log2(k)."""
    if k < 2 or (k & (k - 1)) != 0:
        raise ValueError(f"OPH needs k = power of two >= 2, got {k}")
    return 32 - (int(k).bit_length() - 1)


def _hash_u32(t: np.ndarray, a: int, b: int) -> np.ndarray:
    """Numpy uint32 multiply-shift + murmur finalizer."""
    h = (np.uint32(a) * t.astype(np.uint32) + np.uint32(b)).astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    return h


@dataclasses.dataclass(frozen=True)
class OPHHash:
    """The single hash function of an OPH family: one (a, b) pair, k bins."""

    a: int
    b: int
    k: int

    @staticmethod
    def make(k: int, seed: int) -> "OPHHash":
        _check_k(k)
        rng = np.random.default_rng(np.random.SeedSequence(seed))
        a = int(rng.integers(0, 1 << 32, dtype=np.uint64) | 1)
        b = int(rng.integers(0, 1 << 32, dtype=np.uint64))
        return OPHHash(a=a, b=b, k=k)

    @property
    def shift(self) -> int:
        return _check_k(self.k)

    def params(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b) as int32 bit-pattern tensors of shape (1,)."""
        return (words_to_int32([self.a], device),
                words_to_int32([self.b], device))

    def __call__(self, t: np.ndarray) -> np.ndarray:
        return _hash_u32(np.asarray(t), self.a, self.b)


# ---------------------------------------------------------------------------
# Torch (plain) path: words in int64.
# ---------------------------------------------------------------------------
def oph_bin_minima_torch(indices: torch.Tensor, mask: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin minima of h over each row's masked-in ids.

    indices int32 (n, m), mask bool (n, m), a/b int64 words (1,).
    Returns (vals int64 words (n, k), empty bool (n, k)); empty bins
    hold 2^32 − 1.
    """
    shift = _check_k(k)
    t = indices.to(torch.int64) & MASK32
    h = fmix32((mul32(t, a[0]) + b[0]) & MASK32)
    hv = torch.where(mask, h, MASK32)
    vals = torch.full((indices.shape[0], k), MASK32, dtype=torch.int64,
                      device=indices.device)
    vals = vals.scatter_reduce(1, h >> shift, hv, "amin")
    return vals, vals == MASK32


def densify_rotation(vals: torch.Tensor, empty: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation densification, the torch twin of the reference's
    ``densify_rotation``: each empty bin j takes ``vals[src] +
    dist·_ROT_C`` (mod 2^32) from the nearest non-empty bin to its
    right, circularly.  All-empty rows stay all 2^32 − 1.

    Returns (dense int64 words (n, k), still_empty bool (n, k)).
    """
    n, k = vals.shape
    dev = vals.device
    ne2 = torch.cat([~empty, ~empty], dim=1)
    iota2 = torch.arange(2 * k, dtype=torch.int64, device=dev)
    cand = torch.where(ne2, iota2[None, :], 2 * k)
    nxt = torch.cummin(cand.flip(1), dim=1).values.flip(1)[:, :k]
    dist = nxt - torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    src = torch.where(nxt < 2 * k, nxt % k, 0)
    borrowed = torch.gather(vals, 1, src)
    borrowed = (borrowed + mul32(dist & MASK32, _ROT_C)) & MASK32
    all_empty = empty.all(dim=1, keepdim=True)
    out = torch.where(all_empty | (nxt >= 2 * k), MASK32, borrowed)
    return out, all_empty.expand(n, k).clone()


# ---------------------------------------------------------------------------
# Numpy (host) path: the oracle, and ``encode_packed_numpy``.
# ---------------------------------------------------------------------------
def oph_bin_minima_numpy(
    indices: np.ndarray, mask: np.ndarray, fam: OPHHash,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bin minima of h over each row's masked-in ids of int (n, m)
    ``indices`` → (vals uint32 (n, k), empty bool (n, k)); empty bins
    hold 2^32 − 1.  One hash evaluation per (padded) nonzero."""
    n, m = indices.shape
    h = fam(indices)
    bins = (h >> np.uint32(fam.shift)).astype(np.int64)
    vals = np.full((n, fam.k), UINT32_MAX_NP, dtype=np.uint32)
    hv = np.where(mask, h, UINT32_MAX_NP)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, m))
    np.minimum.at(vals, (rows.ravel(), bins.ravel()), hv.ravel())
    return vals, vals == UINT32_MAX_NP


def oph_bin_minima_ragged_numpy(
    tokens: np.ndarray, lens: np.ndarray, fam: OPHHash,
) -> Tuple[np.ndarray, np.ndarray]:
    """One flat hash pass over every row's valid ids (row-major concat)
    and one flat scatter-min into (n, k) → (vals uint32, empty bool)."""
    n = int(lens.shape[0])
    h = fam(tokens)
    bins = (h >> np.uint32(fam.shift)).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.asarray(lens, dtype=np.int64))
    vals = np.full(n * fam.k, UINT32_MAX_NP, dtype=np.uint32)
    np.minimum.at(vals, rows * np.int64(fam.k) + bins, h)
    vals = vals.reshape(n, fam.k)
    return vals, vals == UINT32_MAX_NP


def densify_rotation_numpy(
    vals: np.ndarray, empty: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of ``densify_rotation`` (bit-exact)."""
    n, k = vals.shape
    ne2 = np.concatenate([~empty, ~empty], axis=1)
    iota2 = np.arange(2 * k, dtype=np.int64)
    cand = np.where(ne2, iota2[None, :], 2 * k)
    nxt = np.minimum.accumulate(cand[:, ::-1], axis=1)[:, ::-1][:, :k]
    dist = nxt - np.arange(k, dtype=np.int64)[None, :]
    src = np.where(nxt < 2 * k, nxt % k, 0)
    borrowed = np.take_along_axis(vals, src, axis=1)
    borrowed = (borrowed
                + (dist.astype(np.uint32) * np.uint32(_ROT_C)).astype(
                    np.uint32)).astype(np.uint32)
    all_empty = empty.all(axis=1, keepdims=True)
    out = np.where(all_empty | (nxt >= 2 * k), UINT32_MAX_NP, borrowed)
    return out.astype(np.uint32), np.broadcast_to(all_empty, (n, k)).copy()


def oph_codes_numpy(
    indices: np.ndarray,
    mask: np.ndarray,
    fam: OPHHash,
    b: int,
    *,
    densify: bool = True,
) -> np.ndarray:
    """End-to-end numpy OPH → uint16 b-bit codes.  Densified, every bin
    holds a code in [0, 2^b); zero-coded (``densify=False``), empty bins
    hold ``OPH_EMPTY_CODE`` (so b ≤ 15)."""
    if not densify and b > 15:
        raise ValueError("oph_zero reserves 0xFFFF: b must be <= 15")
    vals, empty = oph_bin_minima_numpy(indices, mask, fam)
    if densify:
        vals, empty = densify_rotation_numpy(vals, empty)
    codes = (vals & np.uint32((1 << b) - 1)).astype(np.uint16)
    return np.where(empty, OPH_EMPTY_CODE, codes)


# ---------------------------------------------------------------------------
# Estimators.
# ---------------------------------------------------------------------------
def oph_collision_probability(
    v1: np.ndarray, e1: np.ndarray, v2: np.ndarray, e2: np.ndarray,
) -> float:
    """Zero-coding resemblance estimator (arXiv:1208.1259 Eq. 3):
    R̂ = N_match / (k − N_emp), matches counted on jointly non-empty
    bins, jointly empty bins left out of the denominator."""
    both = ~(np.asarray(e1) | np.asarray(e2))
    n_emp = int(np.sum(np.asarray(e1) & np.asarray(e2)))
    denom = v1.shape[-1] - n_emp
    if denom <= 0:
        return 0.0
    return float(np.sum((np.asarray(v1) == np.asarray(v2)) & both) / denom)


def split_zero_codes(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(codes with ``OPH_EMPTY_CODE``) → (gather-safe codes, empty mask)."""
    empty = codes == OPH_EMPTY_CODE
    return np.where(empty, np.uint16(0), codes), empty


def oph_codes_agree(c1: np.ndarray, c2: np.ndarray) -> float:
    """b-bit twin of ``oph_collision_probability`` on uint16 codes with
    the ``OPH_EMPTY_CODE`` sentinel."""
    e1 = c1 == OPH_EMPTY_CODE
    e2 = c2 == OPH_EMPTY_CODE
    both = ~(e1 | e2)
    denom = c1.shape[-1] - int(np.sum(e1 & e2))
    if denom <= 0:
        return 0.0
    return float(np.sum((c1 == c2) & both) / denom)
