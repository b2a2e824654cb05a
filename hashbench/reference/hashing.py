"""Minwise and densified OPH codes, b-bit packing: plain torch on any device.

The hash family (the configurations' ``multiply_shift``): h_j(t) =
fmix32(a_j·t + b_j mod 2^32) with a_j odd, fmix32 MurmurHash3's 32-bit
finalizer.  Its words are drawn from NumPy's ``default_rng`` seeded with
``SeedSequence(seed)``: k words a_j | 1, then k words b_j (minwise); one
a | 1, then one b (OPH).  Words are held in int64 in [0, 2^32); a
product of two words is taken in 16-bit limbs so that nothing passes
2^63.

* Minwise: code_j = the low b bits of min over the row's ids of h_j.
* OPH over k bins (a power of two): one hash a nonzero, bin = h >> (32 -
  log2 k), each bin keeps its minimum; an empty bin borrows the value of
  the nearest non-empty bin to its right, circularly, at distance d,
  plus d·0x9E3779B1 mod 2^32 (rotation densification); a row with no
  id holds 0xFFFFFFFF in every bin.
* Packing: codes LSB-first into ceil(k·b/8) bytes a row.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATION = 0x9E3779B1


def minwise_words(k: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    a = rng.integers(0, 1 << 32, size=k, dtype=np.uint64) | np.uint64(1)
    b = rng.integers(0, 1 << 32, size=k, dtype=np.uint64)
    return a.astype(np.int64), b.astype(np.int64)


def oph_words(seed: int) -> Tuple[int, int]:
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    a = int(rng.integers(0, 1 << 32, dtype=np.uint64)) | 1
    b = int(rng.integers(0, 1 << 32, dtype=np.uint64))
    return a, b


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """x·c mod 2^32 for words x, c in [0, 2^32) (int64)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash32(t: torch.Tensor, a, b) -> torch.Tensor:
    return fmix32((mul32(t, a) + b) & MASK32)


def pack_lsb(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int (n, k) codes < 2^bits → uint8 (n, ceil(k·bits/8)), LSB-first."""
    n, k = codes.shape
    shifts = torch.arange(bits, device=codes.device)
    flat = ((codes.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(n, -1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % 8))
    weights = 1 << torch.arange(8, device=codes.device)
    return (flat.reshape(n, -1, 8) * weights).sum(dim=2).to(torch.uint8)


def _rows(ids: torch.Tensor, nnz: torch.Tensor):
    """int32 (n, m) padded ids, (n,) lengths → (int64 ids, bool mask)."""
    t = ids.to(torch.int64) & MASK32
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] \
        < nnz.to(torch.int64)[:, None]
    return t, mask


def minwise_packed(ids: torch.Tensor, nnz: torch.Tensor, k: int, bits: int,
                   seed: int, *, lanes: int = 25,
                   max_elems: int = 1 << 25) -> torch.Tensor:
    """Packed b-bit minwise codes of padded rows: uint8 (n, ceil(k·b/8)).
    Works in blocks of rows and of ``lanes`` hashes so that an int64
    intermediate holds at most about ``max_elems`` words."""
    a_np, b_np = minwise_words(k, seed)
    a = torch.from_numpy(a_np).to(ids.device)
    b = torch.from_numpy(b_np).to(ids.device)
    n, m = ids.shape
    z = torch.empty((n, k), dtype=torch.int64, device=ids.device)
    rows = max(1, max_elems // max(1, m * lanes))
    for r0 in range(0, n, rows):
        t, mask = _rows(ids[r0:r0 + rows], nnz[r0:r0 + rows])
        for j in range(0, k, lanes):
            h = hash32(t[:, :, None], a[j:j + lanes], b[j:j + lanes])
            h = torch.where(mask[:, :, None], h, MASK32)
            z[r0:r0 + rows, j:j + lanes] = h.amin(dim=1)
    return pack_lsb(z & ((1 << bits) - 1), bits)


def oph_densified_packed(ids: torch.Tensor, nnz: torch.Tensor, k: int,
                         bits: int, seed: int) -> torch.Tensor:
    """Packed b-bit densified OPH codes of padded rows: uint8 (n,
    ceil(k·b/8))."""
    if k < 2 or k & (k - 1):
        raise ValueError(f"OPH needs k a power of two, got {k}")
    a, b = oph_words(seed)
    t, mask = _rows(ids, nnz)
    n = ids.shape[0]
    h = hash32(t, a, b)
    bins = h >> (32 - (k.bit_length() - 1))
    vals = torch.full((n, k), MASK32, dtype=torch.int64, device=ids.device)
    vals.scatter_reduce_(1, bins, torch.where(mask, h, MASK32), "amin")
    hits = torch.zeros((n, k), dtype=torch.int64, device=ids.device)
    hits.scatter_add_(1, bins, mask.to(torch.int64))
    full = hits > 0
    out = torch.where(full, vals, MASK32)
    todo = ~full & full.any(dim=1, keepdim=True)
    for d in range(1, k):
        if not bool(todo.any()):
            break
        take = todo & torch.roll(full, -d, dims=1)
        borrowed = (torch.roll(vals, -d, dims=1) + d * ROTATION) & MASK32
        out = torch.where(take, borrowed, out)
        todo &= ~take
    return pack_lsb(out & ((1 << bits) - 1), bits)
