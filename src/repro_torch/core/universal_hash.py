"""Hash families (counterpart of ``repro/core/universal_hash.py``).

  * ``MultiplyShiftHash`` — h_j(t) = fmix32(a_j·t + b_j mod 2^32), a_j
    odd: the uint32 family the encode kernels evaluate;
  * ``ModPrimeHash`` — the paper's Eq. 17, (c1_j + c2_j·t) mod 2^61 − 1,
    exact, in numpy uint64 (the offline family);
  * ``PermutationHash`` — k explicit random permutations of {0..D−1}.

Parameter generation is copied from the reference, so the same seed
gives the same (a, b) words, (c1, c2) and permutations.

32-bit words in torch: CPU torch has no uint32 add, shift or min, and
int32 ``>>`` is arithmetic, so the plain versions hold each word in
int64 in [0, 2^32).  A product of two such words can pass 2^63, so
``mul32`` multiplies by 16-bit limbs.  The kernels take the same words
as int32 tensors holding their bit patterns (``words_to_int32``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MERSENNE61 = np.uint64((1 << 61) - 1)


def _np_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed))


def _fmix32_numpy(h: np.ndarray) -> np.ndarray:
    """Murmur3 finalizer in numpy uint32 (wraparound arithmetic)."""
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    return h


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x·c) mod 2^32 for int64 words x, c in [0, 2^32) (c a tensor or
    int): x·c_lo < 2^48 and x·c_hi < 2^48, so nothing overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 words in [0, 2^32); bit-exact with
    ``_fmix32_numpy``."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def words_to_int32(words: Sequence[int], device=None) -> torch.Tensor:
    """uint32 words → int32 tensor holding the same bits (kernel form)."""
    arr = np.asarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def int32_to_words(t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``words_to_int32``: int32 bits → int64 words."""
    return t.to(torch.int64) & MASK32


def words_as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → int32 tensor holding the same bits
    (the tensor twin of ``words_to_int32``)."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class MultiplyShiftHash:
    """h_j(t) = fmix32(a_j * t + b_j mod 2^32); ``a_j`` odd."""

    a: Tuple[int, ...]
    b: Tuple[int, ...]

    @property
    def k(self) -> int:
        return len(self.a)

    @staticmethod
    def make(k: int, seed: int) -> "MultiplyShiftHash":
        rng = _np_rng(seed)
        a = (rng.integers(0, 1 << 32, size=k, dtype=np.uint64) | 1).astype(
            np.uint32
        )
        b = rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)
        return MultiplyShiftHash(a=tuple(int(x) for x in a),
                                 b=tuple(int(x) for x in b))

    def params(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b) as int32 bit-pattern tensors of shape (k,)."""
        return (words_to_int32(self.a, device),
                words_to_int32(self.b, device))


# ---------------------------------------------------------------------------
# Mod-prime (paper Eq. 17): exact, numpy uint64, the offline family.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModPrimeHash:
    """h_j(t) = (c1_j + c2_j·t) mod p, p = 2^61 − 1 (Mersenne).  The
    full residue is the hash value (the paper's further ``mod D`` only
    coarsens the ranking minwise hashing uses)."""

    c1: np.ndarray  # uint64 (k,)
    c2: np.ndarray  # uint64 (k,)

    @property
    def k(self) -> int:
        return int(self.c1.shape[0])

    @staticmethod
    def make(k: int, seed: int) -> "ModPrimeHash":
        rng = _np_rng(seed)
        p = int(MERSENNE61)
        c1 = rng.integers(0, p, size=k, dtype=np.uint64)
        c2 = rng.integers(1, p, size=k, dtype=np.uint64)
        return ModPrimeHash(c1=c1, c2=c2)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        """t: int array [...] → uint64 [..., k]; c2·t is split into
        30-bit limbs of t so no uint64 product wraps."""
        t = np.asarray(t, dtype=np.uint64)[..., None]
        t_lo = t & np.uint64((1 << 30) - 1)
        t_hi = t >> np.uint64(30)
        lo = _mulmod_mersenne61(self.c2, t_lo)
        hi = _mulmod_mersenne61(self.c2, t_hi)
        hi = _mulmod_mersenne61(hi, np.uint64(1 << 30))
        s = _addmod_mersenne61(lo, hi)
        return _addmod_mersenne61(s, self.c1)


def _reduce_mersenne61(x: np.ndarray) -> np.ndarray:
    x = (x & MERSENNE61) + (x >> np.uint64(61))
    return np.where(x >= MERSENNE61, x - MERSENNE61, x)


def _addmod_mersenne61(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = a + b  # both < 2^61, so the uint64 sum cannot wrap
    return np.where(s >= MERSENNE61, s - MERSENNE61, s)


def _mulmod_mersenne61(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a·b) mod (2^61 − 1) for a < 2^61, b < 2^31, with no uint64
    overflow: a = a_hi·2^31 + a_lo, and hi·2^31 split again."""
    a_lo = a & np.uint64((1 << 31) - 1)
    a_hi = a >> np.uint64(31)
    lo = _reduce_mersenne61(a_lo * b)
    hi = _reduce_mersenne61(a_hi * b)
    h0 = hi & np.uint64((1 << 30) - 1)
    h1 = hi >> np.uint64(30)
    part0 = _reduce_mersenne61(h0 << np.uint64(31))
    part1 = _reduce_mersenne61(h1)  # h1·2^61 ≡ h1 (mod p)
    return _addmod_mersenne61(lo, _addmod_mersenne61(part0, part1))


# ---------------------------------------------------------------------------
# True random permutations: the gold standard of the paper's Fig. 8.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PermutationHash:
    """k explicit permutations of {0..D−1}; only feasible for small D."""

    perms: np.ndarray  # uint32 (k, D)

    @property
    def k(self) -> int:
        return int(self.perms.shape[0])

    @property
    def dim(self) -> int:
        return int(self.perms.shape[1])

    @staticmethod
    def make(k: int, dim: int, seed: int) -> "PermutationHash":
        rng = _np_rng(seed)
        perms = np.stack(
            [rng.permutation(dim).astype(np.uint32) for _ in range(k)])
        return PermutationHash(perms=perms)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t)
        return np.moveaxis(self.perms[:, t], 0, -1)  # [..., k]


def make_hash_family(kind: str, k: int, seed: int, dim: int = 0):
    if kind == "mod_prime":
        return ModPrimeHash.make(k, seed)
    if kind == "multiply_shift":
        return MultiplyShiftHash.make(k, seed)
    if kind == "permutation":
        if dim <= 0:
            raise ValueError("permutation family needs dim > 0")
        return PermutationHash.make(k, dim, seed)
    raise ValueError(f"unknown hash family {kind!r}")
