"""Multiply-shift hash family (counterpart of ``repro/core/universal_hash.py``).

h_j(t) = fmix32(a_j·t + b_j mod 2^32), a_j odd: the uint32 family the
encode kernels evaluate.  Parameter generation is copied from the
reference so the same seed gives the same (a, b) words.

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


@dataclasses.dataclass(frozen=True)
class MultiplyShiftHash:
    """h_j(t) = fmix32(a_j * t + b_j mod 2^32); ``a_j`` odd."""

    a: Tuple[int, ...]
    b: Tuple[int, ...]

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
